"""Public wrapper for the flash-attention kernel (the counterpart of
``repro/kernels/flashattn/ops.py``): the kernel for tensors on the card,
its plain version for tensors on the CPU, or the oracle on request."""

from __future__ import annotations

from .flashattn import flash_attention
from .ref import attention_ref


def flash_attn(q, k, v, *, causal: bool = True, window: int = 0,
               use_kernel: bool = True):
    """Dispatch: :func:`flash_attention` (kernel or plain version, by
    device), or :func:`attention_ref` with ``use_kernel=False``."""
    if not use_kernel:
        return attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
