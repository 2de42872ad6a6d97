"""The RG-LRU linear recurrence: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/rglru/rglru.py``.  :func:`rglru_scan`
keeps the TPU function's contract — a, b (B, S, D) of one element type
(float32 or bfloat16), h_t = a_t·h_{t−1} + b_t over axis 1 with h_{−1} = 0,
the state carried in float32, h written in a's type — and drops its
``S % chunk == 0`` assert: the last time chunk may be short.

Both versions scan time in chunks of ``chunk`` steps: each chunk's
summary from a zero state (the product of its a's and its local end
state), each chunk's carried-in state as the earlier chunks' summaries
folded in order from zero, then the chunk from that state.  No product is
ever divided out, so a cumulative product that underflows over a long
sequence costs nothing.  ``chunk`` changes only where rounding falls.

Tensors on the card launch ``csrc/rglru_scan.cu`` once: a block a (chunk,
strip of channels) holds its chunk of a and b in registers, publishes its
summary, waits for the earlier chunks' and applies its own, so a and b
are read once.  The kernel keeps its tickets, flags and epoch in a small
device buffer that this module owns for each stream (:func:`_state`).
Tensors on the CPU run :func:`rglru_scan_plain`, the same arithmetic in
PyTorch ops, pass by pass.

The backward is the same recurrence run in reverse: for the cotangent g
of h, λ_t = g_t + a_{t+1}·λ_{t+1} from λ_{S−1} = g_{S−1}, which is
:func:`rglru_scan` of b' = flip(g) and a' = flip(cat(a[:, 1:], 0)), one
launch on the card (:func:`rglru_scan_backward`); then db = λ and da_t =
λ_t·h_{t−1} with h_{−1} = 0.  :func:`rglru_scan_autograd` is the scan as
a ``torch.autograd.Function`` over the two: one forward launch that saves
a and h, one backward launch.
"""

from __future__ import annotations

from ..common import (INT, META, NUM_SMS, PTR, CudaLibrary, dtype_code,
                      meta_result, on_card,
                      stream_of)

# Channels a block of csrc/rglru_scan.cu (one a thread), the steps a
# thread holds in registers (a longer chunk is read twice), the blocks an
# SM holds (its __launch_bounds__) and the state's header words before the
# flags (its FLAGS).
THREADS = 128
HELD = 64
BLOCKS_PER_SM = 3
STATE_HEADER = 96
# The threads the card holds resident: a route's chunks fill at least one
# such wave.
_FILL_THREADS = NUM_SMS * BLOCKS_PER_SM * THREADS

LIBRARY = CudaLibrary("rglru_scan.cu", {
    "codo_rglru_scan": [INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                        PTR],
})

# The kernel's state, one zeroed int32 buffer a (device, stream), grown
# (and zeroed anew) when a call needs more flags than it holds.
_STATES: dict = {}


def chunk_length(B: int, S: int, D: int) -> int:
    """The route's chunk: the longest power of two up to HELD steps whose
    (channel, chunk) threads fill the card's resident threads once, at
    least 16 steps (shorter chunks fold more summaries than they save)."""
    chunk = HELD
    while chunk > 16 and B * D * -(-S // chunk) < _FILL_THREADS:
        chunk //= 2
    return chunk


def launches() -> int:
    """Kernel launches of one :func:`rglru_scan` call on the card, at any
    shape and chunk."""
    return 1


def state_words(B: int, S: int, D: int, chunk: int) -> int:
    """Words of kernel state a call needs: the header, then a flag for
    each block (chunk, strip of THREADS channels, batch)."""
    return STATE_HEADER + B * -(-D // THREADS) * -(-S // chunk)


def _state(device, stream: int, words: int):
    import torch
    key = (device, stream)
    state = _STATES.get(key)
    if state is None or state.numel() < words:
        state = torch.zeros(words, dtype=torch.int32, device=device)
        _STATES[key] = state
    return state


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
    where = on_card(a, b)
    if where is META:                       # one multiply-add an element
        return meta_result(a.shape, a.dtype, (a, b), flops=2.0 * a.numel())
    if not where:
        return rglru_scan_plain(a, b, chunk=chunk)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan reads contiguous a and b")
    B, S, D = a.shape
    L = min(int(chunk), S)
    out = torch.empty_like(a)
    summary = torch.empty((2, B, -(-S // L), D), dtype=torch.float32,
                          device=a.device)
    stream = stream_of(a)
    state = _state(a.device, stream, state_words(B, S, D, L))
    with torch.cuda.device(a.device):
        LIBRARY.launch("codo_rglru_scan", dtype_code(a), a.data_ptr(),
                       b.data_ptr(), out.data_ptr(), summary.data_ptr(),
                       state.data_ptr(), B, S, D, L, stream)
    return out


def rglru_scan_plain(a, b, *, chunk: int = 128):
    """The kernel's arithmetic in plain PyTorch ops, float32 state, pass
    by pass: every chunk's summary, the in-order fold of the summaries
    from zero, every chunk from its carried-in state.  The time axis is
    padded to whole chunks with the identity step (a = 1, b = 0) and the
    chunks are scanned side by side."""
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


def rglru_scan_backward(g, a, h, *, chunk: int = 128):
    """``(da, db)`` of ``h = rglru_scan(a, b)`` for the cotangent ``g`` of
    ``h``: λ by one :func:`rglru_scan` of the reversed operands (the kernel
    on the card, the plain version on the CPU) flipped back, then ``db =
    λ`` and ``da_t = λ_t·h_{t−1}``, all in a's type."""
    import torch
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    lam = rglru_scan(a_next.flip(1), g.to(a.dtype).flip(1),
                     chunk=chunk).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return lam * h_prev, lam


_FUNCTION = None


def _function():
    """The ``torch.autograd.Function`` of the scan, made at first use."""
    global _FUNCTION
    if _FUNCTION is None:
        import torch

        class RglruScan(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, b, chunk):
                h = rglru_scan(a, b, chunk=chunk)
                ctx.chunk = chunk
                ctx.save_for_backward(a, h)
                return h

            @staticmethod
            def backward(ctx, g):
                a, h = ctx.saved_tensors
                da, db = rglru_scan_backward(g.contiguous(), a, h,
                                             chunk=ctx.chunk)
                return da, db, None

        _FUNCTION = RglruScan
    return _FUNCTION


def rglru_scan_autograd(a, b, *, chunk: int = 128):
    """:func:`rglru_scan` that autograd differentiates through
    :func:`rglru_scan_backward`: one launch forward, one backward."""
    return _function().apply(a, b, int(chunk))


__all__ = ["LIBRARY", "chunk_length", "launches", "rglru_scan",
           "rglru_scan_autograd", "rglru_scan_backward", "rglru_scan_plain",
           "state_words"]
