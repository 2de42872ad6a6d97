"""Public wrapper for the RG-LRU recurrence kernel (the counterpart of
``repro/kernels/rglru/ops.py``): the kernel for tensors on the card, its
plain version for tensors on the CPU, or the oracle on request.  The
kernel's form is differentiable on both devices: autograd runs its
backward through the same kernel (:func:`.rglru.rglru_scan_backward`)."""

from __future__ import annotations

from .ref import rglru_ref
from .rglru import rglru_scan_autograd


def rglru(a, b, *, chunk: int = 128, use_kernel: bool = True):
    """Dispatch: :func:`rglru_scan_autograd` (kernel or plain version, by
    device), or :func:`rglru_ref` with ``use_kernel=False``."""
    if not use_kernel:
        return rglru_ref(a, b)
    return rglru_scan_autograd(a, b, chunk=chunk)
