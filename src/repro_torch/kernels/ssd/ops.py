"""Public wrapper for the SSD chunk-state kernel (the counterpart of
``repro/kernels/ssd/ops.py``): the kernel for tensors on the card, its
plain version for tensors on the CPU, or the oracle on request.  The
kernel's form is differentiable on both devices: autograd runs its
backward through the reverse kernel (:func:`.ssd.ssd_chunk_scan_backward`)."""

from __future__ import annotations

from .ref import ssd_chunk_scan_ref
from .ssd import ssd_chunk_scan_autograd


def ssd_states(states, decay, *, use_kernel: bool = True):
    """Dispatch: :func:`ssd_chunk_scan_autograd` (kernel or plain version,
    by device), or :func:`ssd_chunk_scan_ref` with ``use_kernel=False``."""
    if not use_kernel:
        return ssd_chunk_scan_ref(states, decay)
    return ssd_chunk_scan_autograd(states, decay)
