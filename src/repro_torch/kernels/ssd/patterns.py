"""CODO kernel-pattern registration: the SSD inter-chunk state scan.

The counterpart of ``repro/kernels/ssd/patterns.py``.  ``ssd.scan``
claims the single ``scan`` task a traced ``F.ssd_scan(states, decay)``
emits (carried-in chunk states over ``(nc, BH, P, N)`` end states and
``(nc, BH, 1, 1)`` decays) and replaces its sequential generic body with
the CUDA scan — a one-task chain, hence ``allow_single=True``.  The
feasibility guard is the reference's; the factory checks that a block's
decays fit its shared memory (:func:`~repro_torch.kernels.common.smem_ok`)
where the TPU checked the states against its VMEM budget.
"""

from __future__ import annotations

from ...core.routing import KernelPattern, register_kernel_pattern
from ..common import all_f32, smem_ok
from .ssd import smem_bytes, ssd_chunk_scan


def _feasible(graph, tasks) -> bool:
    (t,) = tasks
    if t.spec is None or t.spec.kind != "ssd_scan":
        return False
    st_buf, dec_buf = t.spec.ins
    out_buf = t.spec.outs[0]
    st_shape = graph.buffers[st_buf].shape
    dec_shape = graph.buffers[dec_buf].shape
    if len(st_shape) != 4 or len(dec_shape) != 4:
        return False
    if dec_shape[:2] != st_shape[:2] or dec_shape[2:] != (1, 1):
        return False
    return all_f32(graph, st_buf, dec_buf, out_buf)


def factory(graph, group, tasks, tile=None):
    (t,) = tasks
    st_buf, dec_buf = t.spec.ins
    out_buf = t.spec.outs[0]
    if not smem_ok(smem_bytes(graph.buffers[st_buf].shape[0])):
        return None

    def run(env):
        return {out_buf: ssd_chunk_scan(env[st_buf], env[dec_buf])}

    return run


_REGISTERED = False


def register() -> None:
    """Register the ssd kernel pattern (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_kernel_pattern(KernelPattern(
        name="ssd.scan", pattern=("scan",),
        factory=factory, feasible=_feasible,
        allow_single=True,
        description="Mamba-2 SSD inter-chunk state scan "
                    "(replaces the sequential generic scan)"))
