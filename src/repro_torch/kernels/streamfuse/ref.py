"""Plain PyTorch oracles for the streamfuse matmul kernels (the
``matmul_chain_ref`` and ``matmul_grad_ref`` halves of
``repro/kernels/streamfuse/ref.py``)."""


def matmul_chain_ref(a, w1, w2, ew=()):
    """``ew(a @ w1) @ w2`` — ``ew`` a callable or sequence applied in order."""
    h = a @ w1
    for f in ([ew] if callable(ew) else list(ew)):
        h = f(h)
    return h @ w2


def matmul_grad_ref(a, w, extras=(), ew=None):
    """``ew(a @ w, *extras)`` — the backward matmul + gradient-epilogue
    chain; ``ew`` takes the float32 product plus the residual operands."""
    h = a.float() @ w.float()
    if ew is not None:
        h = ew(h, *extras)
    return h.to(a.dtype)
