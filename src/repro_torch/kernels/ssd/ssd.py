"""The SSD inter-chunk state scan: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/ssd/ssd.py``.  :func:`ssd_chunk_scan`
keeps the TPU function's contract — states (nc, BH, P, N), decay (nc, BH,
1, 1), both of one element type (float32 or bfloat16); returns the state
carried *into* each chunk, h_0 = 0 and h_{c+1} = h_c·decay_c + state_c,
the state carried in float32 and each h_c written in the states' type
before chunk c folds in.

Tensors on the card launch ``csrc/ssd_scan.cu`` (one launch a call):
one thread per (bh, p, n) element walks the chunks in order.  Tensors on
the CPU run :func:`ssd_chunk_scan_plain`, the same loop in PyTorch ops.

The backward runs the same scan in reverse: for the cotangent g of the
emitted states, μ_c = g_c + dec_c·μ_{c+1} from μ_nc = 0 is
:func:`ssd_chunk_scan` of flip(g) and flip(decay), whose output flipped
back is μ_{c+1} for each c, one launch on the card
(:func:`ssd_chunk_scan_backward`); then dstates_c = μ_{c+1} and ddecay_c =
Σ_{P,N} μ_{c+1}·h_c.  :func:`ssd_chunk_scan_autograd` is the scan as a
``torch.autograd.Function`` over the two: one forward launch that saves
decay and the emitted h, one backward launch.
"""

from __future__ import annotations

from ..common import (INT, META, PTR, CudaLibrary, dtype_code, meta_result,
                      on_card, smem_ok, stream_of)

# Threads a block of csrc/ssd_scan.cu: consecutive (p, n) elements of one bh.
THREADS = 256

LIBRARY = CudaLibrary("ssd_scan.cu", {
    "codo_ssd_chunk_scan": [INT, PTR, PTR, PTR, INT, INT, INT, PTR],
})


def smem_bytes(nc: int) -> int:
    """Dynamic shared memory of one block: the bh's nc decays."""
    return 4 * nc


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


def ssd_chunk_scan_backward(g, decay, h):
    """``(dstates, ddecay)`` of ``h = ssd_chunk_scan(states, decay)`` for
    the cotangent ``g`` of ``h``: μ_{c+1} by one :func:`ssd_chunk_scan` of
    the reversed operands (the kernel on the card, the plain version on the
    CPU) flipped back; ``ddecay`` summed in float32 and kept at (nc, BH,
    1, 1), both in the states' type."""
    mu_next = ssd_chunk_scan(g.to(decay.dtype).flip(0),
                             decay.flip(0)).flip(0)
    ddecay = (mu_next.float() * h.float()).sum(dim=(-2, -1), keepdim=True)
    return mu_next, ddecay.to(decay.dtype)


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


__all__ = ["LIBRARY", "smem_bytes", "ssd_chunk_scan",
           "ssd_chunk_scan_autograd", "ssd_chunk_scan_backward",
           "ssd_chunk_scan_plain"]
