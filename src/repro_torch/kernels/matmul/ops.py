"""Public wrapper for the blocked matmul kernel (the counterpart of
``repro/kernels/matmul/ops.py``): the kernel for tensors on the card, its
plain version for tensors on the CPU, or the oracle on request.

``block_m``, ``block_n`` and ``block_k`` are the TPU kernel's VMEM tile.
The Hopper kernel's tile is fixed (128 × 128 outputs on the tensor cores,
32-deep k stages, the accumulator in registers) and masks ragged edges,
so the blocks choose nothing here; they are checked and kept so a caller
of the reference's ``mm`` runs unchanged.  No routing pattern reaches this kernel, as in the
reference.
"""

from __future__ import annotations

from .matmul import matmul
from .ref import matmul_ref


def mm(a, b, *, block_m: int = 128, block_n: int = 128, block_k: int = 128,
       use_kernel: bool = True):
    """Dispatch: :func:`matmul` (kernel or plain version, by device), or
    :func:`matmul_ref` with ``use_kernel=False``."""
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"blocks must be positive, got ({block_m}, "
                         f"{block_n}, {block_k})")
    if not use_kernel:
        return matmul_ref(a, b)
    return matmul(a, b)
