"""Plain PyTorch oracle for the fused matmul chain (the ``matmul_chain_ref``
half of ``repro/kernels/streamfuse/ref.py``)."""


def matmul_chain_ref(a, w1, w2, ew=()):
    """``ew(a @ w1) @ w2`` — ``ew`` a callable or sequence applied in order."""
    h = a @ w1
    for f in ([ew] if callable(ew) else list(ew)):
        h = f(h)
    return h @ w2
