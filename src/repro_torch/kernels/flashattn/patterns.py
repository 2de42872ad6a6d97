"""CODO kernel-pattern registration: the full attention chain.

The counterpart of ``repro/kernels/flashattn/patterns.py``.
``flashattn.mha`` claims ``matmul -> *ewise -> softmax -> matmul`` — the
whole ``softmax(c * q @ kᵀ) @ v`` chain a traced attention block emits
(2-D single-head or 3-D heads-folded-batched operands).  It anchors at
the *first* attention matmul, which precedes the softmax in topo order,
so a feasible match supersedes narrower matches over the same tasks and
the S×S score matrix never materializes in device memory.

The chain carries no mask, so the kernel runs with ``causal=False,
window=0``; interior ``scale`` tasks multiply into the kernel's ``scale``
and kᵀ reaches it as a transposed view (strides, no copy).
"""

from __future__ import annotations

from ...core.routing import KernelPattern, register_kernel_pattern
from ..common import all_f32
from .flashattn import flash_attention, tiling_ok


def _chain_parts(tasks):
    """(mm1, interior ewise list, softmax, mm2) or None if kinds drift."""
    if any(t.spec is None for t in tasks) or len(tasks) < 3:
        return None
    mm1, sm, mm2 = tasks[0], tasks[-2], tasks[-1]
    ews = tasks[1:-2]
    if (mm1.spec.kind, sm.spec.kind, mm2.spec.kind) != (
            "matmul", "softmax", "matmul"):
        return None
    return mm1, ews, sm, mm2


def _feasible(graph, tasks) -> bool:
    parts = _chain_parts(tasks)
    if parts is None:
        return False
    mm1, ews, sm, mm2 = parts
    # Interiors must be pure rescales of the chain value (the 1/√hd).
    prev = mm1.spec.outs[0]
    for t in ews:
        if t.spec.kind != "scale" or t.spec.ins != (prev,):
            return False
        prev = t.spec.outs[0]
    if sm.spec.ins[0] != prev or mm2.spec.ins[0] != sm.spec.outs[0]:
        return False
    q_buf, kt_buf = mm1.spec.ins
    v_buf, out_buf = mm2.spec.ins[1], mm2.spec.outs[0]
    q_shape = graph.buffers[q_buf].shape
    kt_shape = graph.buffers[kt_buf].shape
    v_shape = graph.buffers[v_buf].shape
    if len(q_shape) not in (2, 3) or len(kt_shape) != len(q_shape) \
            or len(v_shape) != len(q_shape):
        return False
    hd = q_shape[-1]
    if kt_shape[-2] != hd or v_shape[-1] != hd:       # kt is (.., hd, Sk)
        return False
    if v_shape[-2] != kt_shape[-1]:                   # Sk agreement
        return False
    if len(q_shape) == 3 and not (q_shape[0] == kt_shape[0] == v_shape[0]):
        return False
    axis = int(sm.spec.attrs.get("axis", -1))
    if axis not in (-1, len(q_shape) - 1):
        return False
    return all_f32(graph, q_buf, kt_buf, v_buf, out_buf)


def _scale_of(ews) -> float:
    c = 1.0
    for t in ews:
        c *= float(t.spec.attrs.get("s", 1.0))
    return c


def factory(graph, group, tasks, tile=None):
    mm1, ews, sm, mm2 = _chain_parts(tasks)
    q_buf, kt_buf = mm1.spec.ins
    v_buf, out_buf = mm2.spec.ins[1], mm2.spec.outs[0]
    if not tiling_ok(graph.buffers[q_buf].shape[-1]):
        return None                     # no tiling fits a block's memory
    c = _scale_of(ews)

    def run(env):
        q, kt, v = env[q_buf], env[kt_buf], env[v_buf]
        batched = q.dim() == 3
        if not batched:
            q, kt, v = q[None], kt[None], v[None]
        # (BH, S, hd) -> (BH, 1, S, hd); kᵀ is swapped back as a view.
        o = flash_attention(q[:, None], kt.transpose(-1, -2)[:, None],
                            v[:, None], causal=False, window=0, scale=c)[:, 0]
        return {out_buf: o if batched else o[0]}

    return run


_REGISTERED = False


def register() -> None:
    """Register the flashattn kernel pattern (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_kernel_pattern(KernelPattern(
        name="flashattn.mha",
        pattern=("matmul", "*ewise", "softmax", "matmul"),
        factory=factory, feasible=_feasible,
        description="full softmax(c·q@kᵀ)@v chain via online-softmax "
                    "streaming (supersedes the softmaxmm tail)"))
