"""CODO kernel-pattern registration for the streamfuse kernels.

The counterpart of ``repro/kernels/streamfuse/ops.py``:

========================  ===========================  =======================
pattern name              op pattern                   kernel
========================  ===========================  =======================
``streamfuse.conv``       ``pad → conv → ewise``       ``fused_pad_conv_relu``
``streamfuse.mmchain``    ``matmul → *ewise → matmul`` ``fused_matmul_chain``
``streamfuse.softmaxmm``  ``softmax → matmul``         ``fused_softmax_matmul``
``streamfuse.mmgrad``     ``matmul → *ewise`` (grad)   ``fused_matmul_grad``
========================  ===========================  =======================

The feasibility guards are the reference's, pure graph analysis.  The
factories turn the chain's elementwise tasks into data for the kernel
(``(kind, attrs)`` stages; for mmgrad also the index of each stage's
residual operand, turned into the kernel's op codes once a route); where
the step runs follows from its operands' device
(:mod:`repro_torch.kernels.common`).  There is no VMEM budget: the
kernels tile what the TPU kernel held whole (mmchain sizes its N1 chunk
to the shared memory, mmgrad's and conv's tiles are fixed and small,
softmaxmm tiles the output columns), so the factories check the tail's
length, and softmaxmm that its tiling fits a block's shared memory.  The
conv chain's ``pad2d`` output is interior to the route and never
materialized: the kernel reads the unpadded input.
"""

from __future__ import annotations

from ...core.routing import KernelPattern, register_kernel_pattern
from ..common import all_f32, smem_ok
from .chain import (MAX_EW, ChainTail, GradTail, fused_matmul_chain,
                    fused_matmul_grad, fused_softmax_matmul,
                    softmax_mm_smem_bytes)
from .ref import pad_conv_relu_ref
from .streamfuse import fused_pad_conv_relu

# Elementwise spec kinds a kernel can replay on a tile: exactly one
# operand (the chain value), attrs-only parameters.
EW_KINDS = frozenset({"relu", "gelu", "scale", "affine", "divc", "rdivc",
                      "identity"})

# Gradient-epilogue kinds (backward chains): chain value first operand,
# residual operands read alongside it at the same (row, column).
GRAD_EW_KINDS = frozenset({"relu_grad", "gelu_grad", "softmax_grad"})


def pad_conv_relu(x, w, *, use_kernel: bool = True):
    """relu(conv2d(pad(x), w)), stride 1, SAME (the Fig. 2 motivating
    chain).  ``use_kernel=False`` runs the oracle ``pad_conv_relu_ref``;
    ``True`` runs :func:`fused_pad_conv_relu`: the kernel for operands on
    the card, its plain version for operands on the CPU, and a raise for
    operands on both."""
    if not use_kernel:
        return pad_conv_relu_ref(x, w)
    return fused_pad_conv_relu(x, w)


def _conv_feasible(graph, tasks) -> bool:
    pad_t, conv_t, relu_t = tasks
    if any(t.spec is None for t in tasks):
        return False
    if (pad_t.spec.kind, conv_t.spec.kind, relu_t.spec.kind) != (
            "pad2d", "conv2d", "relu"):
        return False
    if int(conv_t.spec.attrs.get("stride", 1)) != 1:
        return False
    if int(conv_t.spec.attrs.get("groups", 1)) != 1:
        return False
    if conv_t.spec.ins[0] != pad_t.spec.outs[0]:
        return False
    x_buf, w_buf = pad_t.spec.ins[0], conv_t.spec.ins[1]
    x_shape = graph.buffers[x_buf].shape
    w_shape = graph.buffers[w_buf].shape
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    k = w_shape[-1]
    if w_shape[-2] != k or k % 2 != 1:
        return False
    if int(pad_t.spec.attrs.get("pad", -1)) != k // 2:     # SAME only
        return False
    return all_f32(graph, x_buf, w_buf, relu_t.spec.outs[0])


def _conv_factory(graph, group, tasks, tile=None):
    pad_t, conv_t, relu_t = tasks
    x_buf, w_buf = pad_t.spec.ins[0], conv_t.spec.ins[1]
    out_buf = relu_t.spec.outs[0]

    def run(env):
        return {out_buf: fused_pad_conv_relu(env[x_buf], env[w_buf])}

    return run


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
    tail = ChainTail(ew)

    def run(env):
        # The kernel reads row-major operands; a transpose task hands on a
        # strided view (multi_head_attention's kᵀ as w2), copied here.
        a, w1, w2 = (env[b].contiguous() for b in (a_buf, w1_buf, w2_buf))
        return {out_buf: fused_matmul_chain(a, w1, w2, ew=tail)}

    return run


def _mm_grad_feasible(graph, tasks) -> bool:
    """Backward chains only: a cotangent matmul whose elementwise tail
    contains at least one gradient kind (so forward ``matmul → ewise``
    prefixes are never claimed and the longer ``mmchain`` match still
    supersedes this one over shared tasks)."""
    mm, tail = tasks[0], tasks[1:]
    if any(t.spec is None for t in tasks) or not tail:
        return False
    if mm.spec.kind != "matmul" or len(mm.spec.ins) != 2:
        return False
    a_buf, w_buf = mm.spec.ins
    mn = graph.buffers[mm.spec.outs[0]].shape
    shapes = (graph.buffers[a_buf].shape, graph.buffers[w_buf].shape, mn)
    if any(len(s) != 2 for s in shapes):
        return False
    prev, has_grad = mm.spec.outs[0], False
    for t in tail:
        kind = t.spec.kind
        if kind in GRAD_EW_KINDS:
            has_grad = True
        elif kind not in EW_KINDS:
            return False
        if not t.spec.ins or t.spec.ins[0] != prev:
            return False
        for b in t.spec.ins[1:]:        # residual operands ride the stream
            if graph.buffers[b].shape != mn or not all_f32(graph, b):
                return False
        if kind == "softmax_grad" and int(
                t.spec.attrs.get("axis", -1)) not in (-1, 1):
            return False                # the row pass spans full rows only
        prev = t.spec.outs[0]
    if not has_grad:
        return False
    return all_f32(graph, a_buf, w_buf, tail[-1].spec.outs[0])


def grad_tail(tail_tasks):
    """``(ew, extra_bufs)`` of a gradient epilogue: each stage as ``(kind,
    attrs, extra index)``, the residual operands bound positionally in
    ``extra_bufs`` order (the reference's ``_grad_ew_applier`` order)."""
    ew, extra_bufs = [], []
    for t in tail_tasks:
        residuals = t.spec.ins[1:]      # one for a gradient kind, else none
        ew.append((t.spec.kind, dict(t.spec.attrs),
                   len(extra_bufs) if residuals else None))
        extra_bufs.extend(residuals)
    return tuple(ew), extra_bufs


def _mm_grad_factory(graph, group, tasks, tile=None):
    mm, tail = tasks[0], tasks[1:]
    a_buf, w_buf = mm.spec.ins
    out_buf = tail[-1].spec.outs[0]
    ew, extra_bufs = grad_tail(tail)
    if len(ew) > MAX_EW:
        return None                     # longer tail than the kernel replays
    codes = GradTail(ew, len(extra_bufs))

    def run(env):
        return {out_buf: fused_matmul_grad(env[a_buf], env[w_buf],
                                           *(env[b] for b in extra_bufs),
                                           ew=codes)}

    return run


def _softmax_mm_feasible(graph, tasks) -> bool:
    sm, mm = tasks
    if sm.spec is None or mm.spec is None:
        return False
    if sm.spec.kind != "softmax" or mm.spec.kind != "matmul":
        return False
    s_shape = graph.buffers[sm.spec.ins[0]].shape
    if len(s_shape) != 2 or int(sm.spec.attrs.get("axis", -1)) not in (
            -1, len(s_shape) - 1):
        return False
    if mm.spec.ins[0] != sm.spec.outs[0]:   # probabilities stream in as LHS
        return False
    v_buf = mm.spec.ins[1]
    if len(graph.buffers[v_buf].shape) != 2:
        return False
    return all_f32(graph, sm.spec.ins[0], v_buf, mm.spec.outs[0])


def _softmax_mm_factory(graph, group, tasks, tile=None):
    sm, mm = tasks
    s_buf, v_buf, out_buf = sm.spec.ins[0], mm.spec.ins[1], mm.spec.outs[0]
    if not smem_ok(softmax_mm_smem_bytes(graph.buffers[v_buf].shape[1])):
        return None                     # no tiling fits a block's memory

    def run(env):
        return {out_buf: fused_softmax_matmul(env[s_buf], env[v_buf])}

    return run


_REGISTERED = False


def register() -> None:
    """Register the conv, mmchain, softmaxmm and mmgrad kernel patterns
    with the routing layer in the reference's order (pattern ties go to
    the earlier registration), idempotently — repeated ``register_all()``
    calls do not churn the registry epoch."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_kernel_pattern(KernelPattern(
        name="streamfuse.conv", pattern=("pad", "conv", "ewise"),
        factory=_conv_factory, feasible=_conv_feasible,
        description="fused pad->conv->relu streaming kernel (Fig. 2)"))
    register_kernel_pattern(KernelPattern(
        name="streamfuse.mmchain", pattern=("matmul", "*ewise", "matmul"),
        factory=_mm_chain_factory, feasible=_mm_chain_feasible,
        description="ew(a@w1)@w2 with the intermediate kept on chip"))
    register_kernel_pattern(KernelPattern(
        name="streamfuse.softmaxmm", pattern=("softmax", "matmul"),
        factory=_softmax_mm_factory, feasible=_softmax_mm_feasible,
        description="online-softmax(s)@v streaming attention tail"))
    register_kernel_pattern(KernelPattern(
        name="streamfuse.mmgrad", pattern=("matmul", "*ewise"),
        factory=_mm_grad_factory, feasible=_mm_grad_feasible,
        description="ew(a@w, *residuals) backward gradient epilogue"))
