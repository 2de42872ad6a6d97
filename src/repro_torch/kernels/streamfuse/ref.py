"""Plain PyTorch oracles for the streamfuse kernels (the counterpart of
``repro/kernels/streamfuse/ref.py``)."""


def pad_conv_relu_ref(x, w):
    """``relu(conv2d(pad(x), w))``, stride 1, SAME, in float32 (cuDNN
    without TF32 on the card), back in x's type."""
    import torch

    from ...core.ops import full_f32_convolutions
    p = w.shape[-1] // 2
    xp = torch.nn.functional.pad(x.float(), (p, p, p, p))
    with full_f32_convolutions():
        y = torch.nn.functional.conv2d(xp, w.float())
    return torch.relu(y).to(x.dtype)


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


def softmax_matmul_ref(s, v):
    """``softmax(s, -1) @ v`` in s's type."""
    import torch
    return torch.softmax(s, dim=-1) @ v
