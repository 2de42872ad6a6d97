"""The fused pad → conv → relu kernel for Hopper and its plain version.

The counterpart of ``repro/kernels/streamfuse/streamfuse.py``, the
paper's motivating example (Fig. 2) as one kernel:

``fused_pad_conv_relu(x, w)`` — ``relu(conv2d(pad(x), w))`` for x (N, C,
H, W) and w (CO, C, K, K), stride 1, SAME padding, K odd, one element
type (float32 or bfloat16), float32 accumulation, output (N, CO, H, W) in
x's type.  The padded input is never written: the kernel reads x through
masked loads.

Tensors on the card launch ``csrc/pad_conv_relu.cu``: an implicit GEMM,
output channels × pixels (N·H·W) over the window C·K·K, on the tensor
cores (mma.sync 3×TF32) in tiles of 128 pixels by 64 channels for layers
of up to 64 channels (each 32-deep stage promoted into the float32
accumulator by round-to-nearest adds) or by 128 for wider ones (the
tensor cores accumulate, each split of the window at most
``CONV_WIDE_DEPTH`` deep).  When the tiles are too few to fill the card
the window is split (the rule :func:`~.chain.tile_splits`, at the tile,
stage depth and fitted cost) and a second launch sums the splits in a
fixed order and applies the ReLU.  Deterministic; no atomics.  The
launch plan is kept per shape.  Tensors on the CPU run the plain
version, :func:`pad_conv_relu_plain`.
"""

from __future__ import annotations

import functools
import math

from ..common import (INT, META, NUM_SMS, PTR, CudaLibrary, dtype_code,
                      meta_result, on_card, stream_of)
from .chain import tile_splits

LIBRARY = CudaLibrary("pad_conv_relu.cu", {
    "codo_pad_conv_relu": [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                           INT, INT, INT, INT, PTR],
    "codo_pad_conv_relu_reduce": [INT, PTR, PTR, INT, INT, INT, INT, PTR],
})


# csrc/pad_conv_relu.cu's tiles (NarrowTile, WideTile there): CONV_BN
# pixels by 64 or 128 output channels a block, the window in CONV_STAGE-
# deep stages, two blocks resident on a SM.
CONV_BN, CONV_STAGE = 128, 32
# The wide tile's splits of the window are at most this deep: its tensor
# cores accumulate a split whole, and their error grows with its depth.
CONV_WIDE_DEPTH = 512
# The split rule's cost model (float32, NVIDIA H100 80GB HBM3, fitted to
# the split counts that ran fastest at ResNet-18's and VGG-16's route
# shapes, both tiles): the busiest SM's blocks run two at a time, a k
# taking _CONV_K_US[0] µs for a block alone on its SM, [1] for two.
_CONV_K_US = (0.12, 0.20)


def conv_tile_rows(CO: int) -> int:
    """Output channels a block: 64 for a layer of up to 64 channels (the
    kernel promotes each stage), else 128."""
    return 64 if CO <= 64 else 128


@functools.lru_cache(maxsize=1024)
def conv_splits(x_shape, w_shape) -> tuple[int, int]:
    """(splits, depth of each) of the C·K·K window for this call, kept per
    shape: the search below runs once a route."""
    N, C, H, W = x_shape
    CO, _, K, _ = w_shape
    rows = conv_tile_rows(CO)

    def cost(blocks: int, per: int) -> float:
        """µs of the product; a wide split past CONV_WIDE_DEPTH is not
        taken."""
        if rows == 128 and per > CONV_WIDE_DEPTH:
            return math.inf
        pairs, single = divmod(-(-blocks // NUM_SMS), 2)
        return per * (pairs * _CONV_K_US[1] + single * _CONV_K_US[0])

    return tile_splits(CO, N * H * W, C * K * K, tile=(rows, CONV_BN),
                       stage=CONV_STAGE, cost=cost)


def conv_launches(x_shape, w_shape) -> int:
    """Kernel launches of one :func:`fused_pad_conv_relu` call: the tiled
    product, and the split sum when the window is split."""
    return 1 if conv_splits(tuple(x_shape), tuple(w_shape))[0] == 1 else 2


def _check(x, w):
    import torch
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"fused_pad_conv_relu wants x (N, C, H, W) and w "
                         f"(CO, C, K, K), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    K = w.shape[-1]
    if w.shape[1] != x.shape[1] or w.shape[2] != K or K % 2 != 1:
        raise ValueError(f"w must be (CO, C, K, K) with C = x's channels and "
                         f"K odd, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")


def fused_pad_conv_relu(x, w):
    """``relu(conv2d(pad(x), w))`` (stride 1, SAME): the kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    import torch
    _check(x, w)
    where = on_card(x, w)
    if where is META:
        N, C, H, W = x.shape
        CO, K = w.shape[0], w.shape[-1]
        return meta_result((N, CO, H, W), x.dtype, (x, w),
                           flops=2.0 * N * CO * H * W * C * K * K)
    if not where:
        return pad_conv_relu_plain(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_pad_conv_relu reads contiguous NCHW x and "
                         f"OIHW w; got strides {x.stride()}, {w.stride()}")
    N, C, H, W = x.shape
    CO, K = w.shape[0], w.shape[-1]
    splits, per = conv_splits((N, C, H, W), (CO, C, K, K))
    out = torch.empty((N, CO, H, W), dtype=x.dtype, device=x.device)
    dst = out if splits == 1 else torch.empty(
        (splits, CO, N * H * W), dtype=torch.float32, device=x.device)
    code, stream = dtype_code(x), stream_of(x)
    with torch.cuda.device(x.device):
        LIBRARY.launch("codo_pad_conv_relu", code, x.data_ptr(), w.data_ptr(),
                       dst.data_ptr(), N, C, H, W, CO, K,
                       conv_tile_rows(CO), per, splits, int(splits == 1),
                       stream)
        if splits > 1:
            LIBRARY.launch("codo_pad_conv_relu_reduce", code, dst.data_ptr(),
                           out.data_ptr(), splits, CO, N, H * W, stream)
    return out


def pad_conv_relu_plain(x, w):
    """The TPU kernel's arithmetic in plain PyTorch ops, float32
    throughout: the K·K shifted views of the zero-padded input (the
    window buffer, rows in w's (c, kh, kw) order) contracted with
    ``w.reshape(CO, C·K·K)``, then the ReLU."""
    import torch
    _check(x, w)
    N, C, H, W = x.shape
    CO, K = w.shape[0], w.shape[-1]
    p = K // 2
    xp = torch.nn.functional.pad(x.float(), (p, p, p, p))
    win = torch.stack([xp[:, :, kh:kh + H, kw:kw + W]
                       for kh in range(K) for kw in range(K)], dim=2)
    acc = w.float().reshape(CO, C * K * K) @ win.reshape(N, C * K * K, H * W)
    return torch.relu(acc).reshape(N, CO, H, W).to(x.dtype)


__all__ = ["CONV_BN", "CONV_STAGE", "CONV_WIDE_DEPTH", "LIBRARY",
           "conv_launches", "conv_splits", "conv_tile_rows",
           "fused_pad_conv_relu", "pad_conv_relu_plain"]
