"""CODO kernel-pattern registration: the RG-LRU linear recurrence.

The counterpart of ``repro/kernels/rglru/patterns.py``.  ``rglru.scan``
claims the single ``scan`` task a traced ``F.rglru_scan(a, b)`` emits
(``h_t = a_t·h_{t-1} + b_t`` over axis 1 of ``(B, S, D)`` operands) and
replaces its sequential generic body with the CUDA chunked scan — a
one-task chain, hence ``allow_single=True``.  The feasibility guard is
the reference's.  The TPU factory picked the largest power-of-two chunk
that divides S (its kernel asserts divisibility); the port's takes any S
and picks the chunk that fills the card
(:func:`~repro_torch.kernels.rglru.rglru.chunk_length`).
"""

from __future__ import annotations

from ...core.routing import KernelPattern, register_kernel_pattern
from ..common import all_f32
from .rglru import chunk_length, rglru_scan


def _feasible(graph, tasks) -> bool:
    (t,) = tasks
    if t.spec is None or t.spec.kind != "rglru_scan":
        return False
    a_buf, b_buf = t.spec.ins
    out_buf = t.spec.outs[0]
    a_shape = graph.buffers[a_buf].shape
    if len(a_shape) != 3 or graph.buffers[b_buf].shape != a_shape:
        return False
    return all_f32(graph, a_buf, b_buf, out_buf)


def factory(graph, group, tasks, tile=None):
    (t,) = tasks
    a_buf, b_buf = t.spec.ins
    out_buf = t.spec.outs[0]
    chunk = chunk_length(*graph.buffers[a_buf].shape)

    def run(env):
        return {out_buf: rglru_scan(env[a_buf], env[b_buf], chunk=chunk)}

    return run


_REGISTERED = False


def register() -> None:
    """Register the rglru kernel pattern (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_kernel_pattern(KernelPattern(
        name="rglru.scan", pattern=("scan",),
        factory=factory, feasible=_feasible,
        allow_single=True,
        description="chunked RG-LRU linear recurrence h=a·h+b "
                    "(replaces the sequential generic scan)"))
