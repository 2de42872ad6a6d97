"""The fused pad → conv → relu kernel for Hopper and its plain version.

The counterpart of ``repro/kernels/streamfuse/streamfuse.py``, the
paper's motivating example (Fig. 2) as one kernel:

``fused_pad_conv_relu(x, w)`` — ``relu(conv2d(pad(x), w))`` for x (N, C,
H, W) and w (CO, C, K, K), stride 1, SAME padding, K odd, one element
type (float32 or bfloat16), float32 accumulation, output (N, CO, H, W) in
x's type.  The padded input is never written: the kernel reads x through
masked loads.

Tensors on the card launch ``csrc/pad_conv_relu.cu``: an implicit GEMM,
output channels × pixels (N·H·W) over the window C·K·K, in 64 × 128
tiles of float32 FMAs; when the tiles are too few to fill the card the
window is split (the rule :func:`~.chain.tile_splits`, at this kernel's
tile, block and stage depth) and a second launch sums the splits in a
fixed order and applies the ReLU.  Deterministic; no atomics.
Tensors on the CPU run the plain version, :func:`pad_conv_relu_plain`.
"""

from __future__ import annotations

from ..common import (INT, NUM_SMS, PTR, CudaLibrary, dtype_code, on_card,
                      stream_of)
from .chain import tile_splits

LIBRARY = CudaLibrary("pad_conv_relu.cu", {
    "codo_pad_conv_relu": [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                           INT, INT, INT, PTR],
    "codo_pad_conv_relu_reduce": [INT, PTR, PTR, INT, INT, INT, INT, PTR],
})


# The split rule's constants for csrc/pad_conv_relu.cu (gemm_tile.cuh): a
# 64 × 128 output tile a 128-thread block, 8-deep stages, three blocks a
# SM, and one wave of them advancing one k in about 0.254 µs (measured on
# an H100 with the same tile).
_CONV_TILE, _CONV_STAGE, _CONV_SLOTS, _CONV_WAVE_K_US = ((64, 128), 8,
                                                         3 * NUM_SMS, 0.254)


def conv_splits(x_shape, w_shape) -> tuple[int, int]:
    """(splits, depth of each) of the C·K·K window for this call."""
    N, C, H, W = x_shape
    CO, _, K, _ = w_shape
    return tile_splits(CO, N * H * W, C * K * K, tile=_CONV_TILE,
                       stage=_CONV_STAGE, cost=_conv_cost)


def _conv_cost(blocks: int, per: int) -> float:
    """µs of the conv kernel's product: waves of resident blocks times
    their depth."""
    return -(-blocks // _CONV_SLOTS) * per * _CONV_WAVE_K_US


def conv_launches(x_shape, w_shape) -> int:
    """Kernel launches of one :func:`fused_pad_conv_relu` call: the tiled
    product, and the split sum when the window is split."""
    return 1 if conv_splits(x_shape, w_shape)[0] == 1 else 2


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
    if not on_card(x, w):
        return pad_conv_relu_plain(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_pad_conv_relu reads contiguous NCHW x and "
                         f"OIHW w; got strides {x.stride()}, {w.stride()}")
    N, C, H, W = x.shape
    CO, K = w.shape[0], w.shape[-1]
    splits, per = conv_splits(x.shape, w.shape)
    out = torch.empty((N, CO, H, W), dtype=x.dtype, device=x.device)
    dst = out if splits == 1 else torch.empty(
        (splits, CO, N * H * W), dtype=torch.float32, device=x.device)
    code, stream = dtype_code(x), stream_of(x)
    with torch.cuda.device(x.device):
        LIBRARY.launch("codo_pad_conv_relu", code, x.data_ptr(), w.data_ptr(),
                       dst.data_ptr(), N, C, H, W, CO, K, per, splits,
                       int(splits == 1), stream)
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


__all__ = ["LIBRARY", "conv_launches", "conv_splits", "fused_pad_conv_relu",
           "pad_conv_relu_plain"]
