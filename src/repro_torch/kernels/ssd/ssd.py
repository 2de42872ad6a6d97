"""The SSD inter-chunk state scan: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/ssd/ssd.py``.  :func:`ssd_chunk_scan`
keeps the TPU function's contract — states (nc, BH, P, N), decay (nc, BH,
1, 1), both of one element type (float32 or bfloat16); returns the state
carried *into* each chunk, h_0 = 0 and h_{c+1} = h_c·decay_c + state_c,
the state carried in float32 and each h_c written in the states' type
before chunk c folds in.

Tensors on the card launch ``csrc/ssd_scan.cu`` (one launch a call): a
thread owns four consecutive (p, n) elements of one bh and walks the
chunks in order.  Tensors on the CPU run :func:`ssd_chunk_scan_plain`,
the same loop in PyTorch ops.

The backward is a kernel of its own (:func:`ssd_chunk_scan_backward`, one
launch): for the cotangent g of the emitted states it walks the chunks
from the last down, μ_nc = 0, dstates_c = μ_{c+1}, μ_c = g_c +
dec_c·μ_{c+1} (μ in float32), and sums ddecay_c = Σ_{P,N} μ_{c+1}·h_c in
the same pass with μ rounded to the states' type before the product, in a
fixed order (no float atomics: two runs are bit for bit the same).  On the
CPU it runs :func:`ssd_chunk_scan_backward_plain`, the same reverse loop.
:func:`ssd_chunk_scan_autograd` is the scan as a
``torch.autograd.Function`` over the two: one forward launch that saves
decay and the emitted h, one backward launch.
"""

from __future__ import annotations

from ..common import (INT, META, PTR, CudaLibrary, dtype_code, meta_result,
                      on_card, smem_ok, stream_of)

# Threads a block of csrc/ssd_scan.cu, each on four consecutive (p, n)
# elements of one bh; the backward's warps a block.
THREADS = 256
WARPS = THREADS // 32

LIBRARY = CudaLibrary("ssd_scan.cu", {
    "codo_ssd_chunk_scan": [INT, PTR, PTR, PTR, INT, INT, INT, PTR],
    "codo_ssd_chunk_scan_backward": [INT, PTR, PTR, PTR, PTR, PTR, INT, INT,
                                     INT, PTR],
})


def smem_bytes(nc: int) -> int:
    """Dynamic shared memory of one forward block: the bh's nc decays."""
    return 4 * nc


def backward_smem_bytes(nc: int) -> int:
    """Dynamic shared memory of one backward block: the bh's nc decays,
    each warp's part of the nc sums Σ μ·h and the block's."""
    return 4 * nc * (WARPS + 2)


def _check(states, decay):
    import torch
    if states.dim() != 4 or decay.dim() != 4:
        raise ValueError(f"ssd_chunk_scan wants 4-D states and decay, got "
                         f"{tuple(states.shape)} and {tuple(decay.shape)}")
    nc, BH = states.shape[:2]
    if tuple(decay.shape) != (nc, BH, 1, 1):
        raise ValueError(f"decay must be (nc={nc}, BH={BH}, 1, 1), got "
                         f"{tuple(decay.shape)}")
    if states.dtype != decay.dtype or states.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise TypeError(f"states/decay must share float32 or bfloat16, got "
                        f"{states.dtype}, {decay.dtype}")


def ssd_chunk_scan(states, decay):
    """states: (nc, BH, P, N); decay: (nc, BH, 1, 1).  Returns h_prev (nc,
    BH, P, N): the kernel on the card, the plain version on the CPU."""
    import torch
    _check(states, decay)
    where = on_card(states, decay)
    if where is META:                       # one multiply-add an element
        return meta_result(states.shape, states.dtype, (states, decay),
                           flops=2.0 * states.numel())
    if not where:
        return ssd_chunk_scan_plain(states, decay)
    if not (states.is_contiguous() and decay.is_contiguous()):
        raise ValueError("ssd_chunk_scan reads contiguous states and decay")
    nc, BH, P, N = states.shape
    if not smem_ok(smem_bytes(nc)):
        raise ValueError(f"ssd_chunk_scan holds a block's {nc} decays in "
                         f"shared memory: too many chunks")
    out = torch.empty_like(states)
    with torch.cuda.device(states.device):
        LIBRARY.launch("codo_ssd_chunk_scan", dtype_code(states),
                       states.data_ptr(), decay.data_ptr(), out.data_ptr(),
                       nc, BH, P * N, stream_of(states))
    return out


def ssd_chunk_scan_plain(states, decay):
    """The kernel's function in plain PyTorch ops: the float32 state
    carried over the chunks in order, each h_c emitted before the fold."""
    import torch
    _check(states, decay)
    h = torch.zeros(states.shape[1:], dtype=torch.float32,
                    device=states.device)
    prevs = []
    for c in range(states.shape[0]):
        prevs.append(h.to(states.dtype))
        h = h * decay[c].float() + states[c].float()
    return torch.stack(prevs, dim=0)


def _check_backward(g, decay, h):
    _check(h, decay)
    if tuple(g.shape) != tuple(h.shape):
        raise ValueError(f"ssd_chunk_scan_backward wants g shaped as h "
                         f"{tuple(h.shape)}, got {tuple(g.shape)}")


def ssd_chunk_scan_backward(g, decay, h):
    """``(dstates, ddecay)`` of ``h = ssd_chunk_scan(states, decay)`` for
    the cotangent ``g`` of ``h`` (cast to the states' type): one launch of
    the reverse kernel on the card, :func:`ssd_chunk_scan_backward_plain`
    on the CPU; ``ddecay`` at (nc, BH, 1, 1), both in the states' type."""
    import torch
    g = g.to(decay.dtype)
    _check_backward(g, decay, h)
    where = on_card(g, decay, h)
    if where is META:          # μ·dec + g, μ·h and its sum: four an element
        ddecay = torch.empty(decay.shape, dtype=decay.dtype, device="meta")
        return meta_result(g.shape, g.dtype, (g, decay, h, ddecay),
                           flops=4.0 * g.numel()), ddecay
    if not where:
        return ssd_chunk_scan_backward_plain(g, decay, h)
    if not all(t.is_contiguous() for t in (g, decay, h)):
        raise ValueError("ssd_chunk_scan_backward reads contiguous g, "
                         "decay and h")
    nc, BH, P, N = g.shape
    if not smem_ok(backward_smem_bytes(nc)):
        raise ValueError(f"ssd_chunk_scan_backward holds a block's {nc} "
                         f"decays and sums in shared memory: too many "
                         f"chunks")
    dstates = torch.empty_like(g)
    ddecay = torch.empty_like(decay)
    with torch.cuda.device(g.device):
        LIBRARY.launch("codo_ssd_chunk_scan_backward", dtype_code(g),
                       g.data_ptr(), decay.data_ptr(), h.data_ptr(),
                       dstates.data_ptr(), ddecay.data_ptr(), nc, BH, P * N,
                       stream_of(g))
    return dstates, ddecay


def ssd_chunk_scan_backward_plain(g, decay, h):
    """The backward kernel's function in plain PyTorch ops: the reverse
    loop with μ carried in float32, each μ_{c+1} emitted in the states'
    type and its product with h_c summed in float32."""
    import torch
    _check_backward(g, decay, h)
    mu = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    dstates, ddecay = [], []
    for c in range(g.shape[0] - 1, -1, -1):
        m = mu.to(g.dtype)
        dstates.append(m)
        ddecay.append((m.float() * h[c].float()).sum(dim=(-2, -1),
                                                     keepdim=True))
        mu = mu * decay[c].float() + g[c].float()
    return (torch.stack(dstates[::-1], dim=0),
            torch.stack(ddecay[::-1], dim=0).to(g.dtype))


_FUNCTION = None


def _function():
    """The ``torch.autograd.Function`` of the scan, made at first use."""
    global _FUNCTION
    if _FUNCTION is None:
        import torch

        class SsdChunkScan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, states, decay):
                h = ssd_chunk_scan(states, decay)
                ctx.save_for_backward(decay, h)
                return h

            @staticmethod
            def backward(ctx, g):
                decay, h = ctx.saved_tensors
                return ssd_chunk_scan_backward(g.contiguous(), decay, h)

        _FUNCTION = SsdChunkScan
    return _FUNCTION


def ssd_chunk_scan_autograd(states, decay):
    """:func:`ssd_chunk_scan` that autograd differentiates through
    :func:`ssd_chunk_scan_backward`: one launch forward, one backward."""
    return _function().apply(states, decay)


__all__ = ["LIBRARY", "backward_smem_bytes", "smem_bytes", "ssd_chunk_scan",
           "ssd_chunk_scan_autograd", "ssd_chunk_scan_backward",
           "ssd_chunk_scan_backward_plain", "ssd_chunk_scan_plain"]
