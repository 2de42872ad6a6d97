"""The RG-LRU linear recurrence: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/rglru/rglru.py``.  :func:`rglru_scan`
keeps the TPU function's contract — a, b (B, S, D) of one element type
(float32 or bfloat16), h_t = a_t·h_{t−1} + b_t over axis 1 with h_{−1} = 0,
the state carried in float32, h written in a's type — and drops its
``S % chunk == 0`` assert: the last time chunk may be short.

Both versions scan time in chunks of ``chunk`` steps, in two passes:
each chunk's summary from a zero state (the product of its a's and its
local end state), then each chunk again from its carried-in state, which
folds the earlier chunks' summaries in order.  No product is ever divided
out, so a cumulative product that underflows over a long sequence costs
nothing.  ``chunk`` changes only where rounding falls.

Tensors on the card launch ``csrc/rglru_scan.cu`` (the summary pass, then
the apply pass: two launches, one when S fits one chunk); tensors on the
CPU run :func:`rglru_scan_plain`, the same two passes in PyTorch ops.
"""

from __future__ import annotations

from ..common import INT, PTR, CudaLibrary, dtype_code, on_card, stream_of

# Threads a block of csrc/rglru_scan.cu, one a (b, d) channel of one chunk.
THREADS = 256
# Half the threads an H100 holds resident (132 SMs × 2048): 32 warps an
# SM, each with 16 loads in flight, keep a streaming pass near its rate.
_FILL_THREADS = 132 * 2048 // 2

LIBRARY = CudaLibrary("rglru_scan.cu", {
    "codo_rglru_chunk_summary": [INT, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                 PTR],
    "codo_rglru_chunk_apply": [INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                               INT, PTR],
})


def chunk_length(B: int, S: int, D: int) -> int:
    """The route's chunk: the longest power of two up to 128 steps whose
    (channel, chunk) threads reach half the card, at least 16 steps
    (shorter chunks fold more summaries than they save)."""
    chunk = 128
    while chunk > 16 and B * D * -(-S // chunk) < _FILL_THREADS:
        chunk //= 2
    return chunk


def launches(S: int, chunk: int) -> int:
    """Kernel launches of one :func:`rglru_scan` call on the card."""
    return 1 if S <= chunk else 2


def _check(a, b, chunk):
    import torch
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"rglru_scan wants a and b of one (B, S, D) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a/b must share float32 or bfloat16, got {a.dtype}, "
                        f"{b.dtype}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be a positive step count, got {chunk}")


def rglru_scan(a, b, *, chunk: int = 128):
    """a, b: (B, S, D) -> h: (B, S, D) with h_t = a_t·h_{t−1} + b_t: the
    kernel on the card, the plain version on the CPU."""
    import torch
    _check(a, b, chunk)
    if not on_card(a, b):
        return rglru_scan_plain(a, b, chunk=chunk)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan reads contiguous a and b")
    B, S, D = a.shape
    L = min(int(chunk), S)
    nch = -(-S // L)
    out = torch.empty_like(a)
    summary = torch.empty((2, B, nch, D), dtype=torch.float32,
                          device=a.device)
    prod, local = summary[0], summary[1]
    code, stream = dtype_code(a), stream_of(a)
    with torch.cuda.device(a.device):
        if nch > 1:
            LIBRARY.launch("codo_rglru_chunk_summary", code, a.data_ptr(),
                           b.data_ptr(), prod.data_ptr(), local.data_ptr(),
                           B, S, D, L, stream)
        LIBRARY.launch("codo_rglru_chunk_apply", code, a.data_ptr(),
                       b.data_ptr(), prod.data_ptr(), local.data_ptr(),
                       out.data_ptr(), B, S, D, L, stream)
    return out


def rglru_scan_plain(a, b, *, chunk: int = 128):
    """The kernel's two passes in plain PyTorch ops, float32 state: the
    time axis padded to whole chunks with the identity step (a = 1,
    b = 0), the chunks scanned side by side."""
    import torch
    _check(a, b, chunk)
    B, S, D = a.shape
    L = min(int(chunk), S)
    nch = -(-S // L)
    pad = nch * L - S
    af = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, pad), value=0.0)
    af, bf = af.view(B, nch, L, D), bf.view(B, nch, L, D)
    prod = torch.ones((B, nch, D), dtype=torch.float32, device=a.device)
    local = torch.zeros_like(prod)
    for t in range(L):                      # pass 1: chunk summaries
        prod = prod * af[:, :, t]
        local = af[:, :, t] * local + bf[:, :, t]
    h = torch.zeros((B, D), dtype=torch.float32, device=a.device)
    carried = []
    for c in range(nch):                    # each chunk's carried-in state
        carried.append(h)
        h = prod[:, c] * h + local[:, c]
    h = torch.stack(carried, dim=1)
    hs = []
    for t in range(L):                      # pass 2: apply from the carry
        h = af[:, :, t] * h + bf[:, :, t]
        hs.append(h)
    out = torch.stack(hs, dim=2).reshape(B, nch * L, D)[:, :S]
    return out.to(a.dtype)


__all__ = ["LIBRARY", "chunk_length", "launches", "rglru_scan",
           "rglru_scan_plain"]
