"""CODO kernel-pattern registration for the streamfuse matmul chain.

The counterpart of the ``streamfuse.mmchain`` half of
``repro/kernels/streamfuse/ops.py``:

=======================  ===========================  =====================
pattern name             op pattern                   kernel
=======================  ===========================  =====================
``streamfuse.mmchain``   ``matmul → *ewise → matmul`` ``fused_matmul_chain``
=======================  ===========================  =====================

The feasibility guard is the reference's, pure graph analysis.  The
factory turns the chain's elementwise tasks into ``(kind, attrs)`` data
for the kernel; where the step runs follows from its operands' device
(:mod:`repro_torch.kernels.common`).  ``streamfuse.conv``,
``streamfuse.softmaxmm`` and ``streamfuse.mmgrad`` are not ported yet.
"""

from __future__ import annotations

from ...core.routing import KernelPattern, register_kernel_pattern
from ..common import all_f32
from .chain import MAX_EW, fused_matmul_chain

# Elementwise spec kinds a kernel can replay on a tile: exactly one
# operand (the chain value), attrs-only parameters.
EW_KINDS = frozenset({"relu", "gelu", "scale", "affine", "divc", "rdivc",
                      "identity"})


def _mm_chain_feasible(graph, tasks) -> bool:
    first, last = tasks[0], tasks[-1]
    if any(t.spec is None for t in tasks):
        return False
    if first.spec.kind != "matmul" or last.spec.kind != "matmul":
        return False
    prev_out = first.spec.outs[0]
    for t in tasks[1:-1]:
        if t.spec.kind not in EW_KINDS or t.spec.ins != (prev_out,):
            return False
        prev_out = t.spec.outs[0]
    if last.spec.ins[0] != prev_out:    # chain value must stream in as LHS
        return False
    bufs = (*first.spec.ins, last.spec.ins[1], last.spec.outs[0])
    if any(len(graph.buffers[b].shape) != 2 for b in bufs[:3]):
        return False
    return all_f32(graph, *bufs)


def _mm_chain_factory(graph, group, tasks, tile=None):
    first, last = tasks[0], tasks[-1]
    a_buf, w1_buf = first.spec.ins
    w2_buf = last.spec.ins[1]
    out_buf = last.spec.outs[0]
    ew = tuple((t.spec.kind, dict(t.spec.attrs)) for t in tasks[1:-1])
    if len(ew) > MAX_EW:
        return None                     # longer tail than the kernel replays

    def run(env):
        return {out_buf: fused_matmul_chain(env[a_buf], env[w1_buf],
                                            env[w2_buf], ew=ew)}

    return run


_REGISTERED = False


def register() -> None:
    """Register the mmchain kernel pattern with the routing layer
    (idempotent — repeated ``register_all()`` calls do not churn the
    registry epoch)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_kernel_pattern(KernelPattern(
        name="streamfuse.mmchain", pattern=("matmul", "*ewise", "matmul"),
        factory=_mm_chain_factory, feasible=_mm_chain_feasible,
        description="ew(a@w1)@w2 with the intermediate kept on chip"))
