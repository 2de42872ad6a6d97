"""Tracing frontend: plain Python functions -> CODO dataflow graphs.

This is the automation layer the paper's pitch promises (§III: the
compiler takes a *high-level description* and emits an optimized dataflow
design).  Instead of hand-assembling a :class:`~repro_torch.core.graph.
DataflowGraph` task by task, a workload is a plain Python function over
symbolic :class:`ShapedBuffer` arguments:

.. code-block:: python

    from repro_torch.core import frontend as F

    def model(x):                       # x: ShapedBuffer
        h = F.fc(x, 512, relu=True)
        return F.fc(h, 512) + x         # residual skip (Fig. 4a bypass)

    graph = F.trace(model, (64, 512), name="residual")

Tracing executes ``model`` once: every op call records a task — the
*same* :class:`~repro_torch.core.ops.OpSpec` + affine ``Loop``/``Access``
structure the hand-built graphs carry, emitted through the :class:`GB`
builder — so a traced graph is structurally **identical** (same
``structural_hash``, same compile-cache key) to the equivalent hand-built
one.  Positional arguments become ``input`` buffers named after the
function's parameters; ops that need parameters (``fc``, ``conv``) declare
``weight`` buffers internally; returned buffers become ``output``s.

Every op is *polymorphic*: called on :class:`ShapedBuffer`\\ s it records a
task, called on concrete arrays it executes the registered reference
implementation eagerly.  A traced function therefore also runs as plain
Python — ``model(torch.ones(64, 512))`` returns numbers — which is what
``repro_torch.api.CompiledProgram`` verifies compiled designs against.  Weights
created inside an op (eager mode has no graph to attach them to) are
deterministic functions of their *shape* (:func:`weight_init`), and the
compiled program binds the same initializer to its weight buffers, so
``codo.compile(fn)(x) == fn(x)`` holds exactly.

Graph construction stays torch-free (the module imports only numpy); eager
execution materializes registry implementations, which import torch
lazily.  In eager mode a numpy operand (an ``fc`` weight from
:func:`weight_init`, a constant) becomes a tensor on the device and at the
dtype of the op's tensor operand.
"""

from __future__ import annotations

import inspect
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from .graph import (Access, Buffer, DataflowGraph, Loop, Task, conv2d_task,
                    ewise_task, full_index, idx, matmul_task, pad_task,
                    pool_task)
from .ops import OpSpec, materialize


class TraceError(TypeError):
    """Raised on misuse of the tracing frontend (mixed traces, non-buffer
    returns, unknown argument specs...)."""


# --------------------------------------------------------------------------
# GB — the low-level graph builder (the vocabulary both the tracer and
# hand-built model code emit through).  Historically lived in
# repro.models.dataflow_models; it moved here so the frontend does not
# depend on the model zoo.  Every method returns the *name* of the buffer
# it produced and tracks shapes, so chained calls read like the math.
# --------------------------------------------------------------------------


class GB:
    """Graph-builder: tracks shapes, emits tasks with declarative specs."""

    def __init__(self, name: str):
        self.g = DataflowGraph(name)
        self.n = 0
        self.shape: dict[str, tuple[int, ...]] = {}

    def fresh(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    def buf(self, name: str, shape, kind="intermediate") -> str:
        self.g.buffer(name, shape, kind=kind)
        self.shape[name] = tuple(shape)
        return name

    def input(self, name: str, shape) -> str:
        return self.buf(name, shape, "input")

    def weight(self, name: str, shape) -> str:
        return self.buf(name, shape, "weight")

    def mark_output(self, name: str) -> None:
        self.g.buffers[name].kind = "output"

    # ---- CNN ops ---------------------------------------------------------

    def pad(self, x: str, p: int) -> str:
        n, c, h, w = self.shape[x]
        out = self.buf(self.fresh("pad"), (n, c, h + 2 * p, w + 2 * p))
        self.g.add_task(pad_task(
            self.fresh("padding"), out, x, n, c, h, w, p,
            spec=OpSpec("pad2d", (x,), (out,), {"pad": p})))
        return out

    def pad_pair(self, x: str, p: int) -> str:
        """Zero-pad expressed as the paper's *init/pad pair* (Fig. 4b):
        one task zero-initializes the padded canvas, a second writes the
        interior — two producers of one buffer, the MPSC violation the
        coarse pass eliminates by producer fusion."""
        n, c, h, w = self.shape[x]
        padded = (n, c, h + 2 * p, w + 2 * p)
        dtype = np.dtype(self.g.buffers[x].dtype)
        out = self.buf(self.fresh("pad"), padded)
        self.g.buffers[out].dtype = dtype    # canvas keeps the input's dtype
        init = Task(self.fresh("pad_init"),
                    loops=[Loop("n", n), Loop("c", c),
                           Loop("h", h + 2 * p), Loop("w", w + 2 * p)],
                    reads=[],
                    writes=[Access(out, full_index(["n", "c", "h", "w"]), True)],
                    op="pad", flops_per_iter=0.0,
                    spec=OpSpec("zeros", (), (out,),
                                {"shape": padded, "dtype": dtype.name}))
        fill = Task(self.fresh("pad_fill"),
                    loops=[Loop("n", n), Loop("c", c), Loop("h", h), Loop("w", w)],
                    reads=[Access(x, full_index(["n", "c", "h", "w"]), False)],
                    writes=[Access(out, full_index(["n", "c", "h", "w"]), True)],
                    op="pad", flops_per_iter=0.0,
                    spec=OpSpec("fill_interior", (x,), (out,), {"pad": p}))
        self.g.add_task(init)
        self.g.add_task(fill)
        return out

    def conv(self, x: str, co: int, k: int, stride: int = 1, pad: int = -1,
             relu: bool = True, depthwise: bool = False) -> str:
        if pad < 0:
            pad = k // 2
        if pad:
            x = self.pad(x, pad)
        n, ci, hp, wp = self.shape[x]
        oh, ow = (hp - k) // stride + 1, (wp - k) // stride + 1
        groups = ci if depthwise else 1
        co_eff = ci if depthwise else co
        wname = self.weight(self.fresh("w"),
                            (co_eff, 1 if depthwise else ci, k, k))
        out = self.buf(self.fresh("conv"), (n, co_eff, oh, ow))

        conv_spec = OpSpec("conv2d", (x, wname), (out,),
                           {"stride": stride, "groups": groups})

        if depthwise:
            t = Task(self.fresh("dwconv"),
                     loops=[Loop("n", n), Loop("c", co_eff), Loop("h", oh),
                            Loop("w", ow), Loop("kh", k), Loop("kw", k)],
                     reads=[Access(x, (idx("n"), idx("c"),
                                       idx(("h", stride), "kh"),
                                       idx(("w", stride), "kw")), False),
                            Access(wname, (idx("c"), (), idx("kh"), idx("kw")),
                                   False)],
                     writes=[Access(out, (idx("n"), idx("c"), idx("h"),
                                          idx("w")), True)],
                     op="conv", flops_per_iter=2.0, spec=conv_spec)
            self.g.add_task(t)
        else:
            self.g.add_task(conv2d_task(self.fresh("conv2d"), out, x, wname,
                                        n, co_eff, ci, oh, ow, k, k,
                                        spec=conv_spec, stride=stride))
        if relu:
            out = self.relu(out)
        return out

    def relu(self, x: str) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("relu"), shp)
        dims = ["n", "c", "h", "w"][:len(shp)] if len(shp) == 4 else None
        self.g.add_task(ewise_task(
            self.fresh("relu_t"), out, [x], shp, op="ewise",
            spec=OpSpec("relu", (x,), (out,)), dim_names=dims))
        return out

    def gelu(self, x: str) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("gelu"), shp)
        self.g.add_task(ewise_task(
            self.fresh("gelu_t"), out, [x], shp, op="ewise", flops_per_iter=8.0,
            spec=OpSpec("gelu", (x,), (out,))))
        return out

    def add(self, a: str, b: str) -> str:
        shp = self.shape[a]
        out = self.buf(self.fresh("add"), shp)
        dims = ["n", "c", "h", "w"][:len(shp)] if len(shp) == 4 else None
        self.g.add_task(ewise_task(
            self.fresh("add_t"), out, [a, b], shp, op="ewise",
            spec=OpSpec("add", (a, b), (out,)), dim_names=dims))
        return out

    def maxpool(self, x: str, k: int) -> str:
        n, c, h, w = self.shape[x]
        oh, ow = h // k, w // k
        out = self.buf(self.fresh("pool"), (n, c, oh, ow))
        self.g.add_task(pool_task(
            self.fresh("maxpool"), out, x, n, c, oh, ow, k,
            spec=OpSpec("maxpool2d", (x,), (out,), {"k": k})))
        return out

    def global_avgpool(self, x: str) -> str:
        n, c, h, w = self.shape[x]
        out = self.buf(self.fresh("gap"), (n, c))
        t = Task(self.fresh("gap_t"),
                 loops=[Loop("n", n), Loop("c", c), Loop("h", h), Loop("w", w)],
                 reads=[Access(x, full_index(["n", "c", "h", "w"]), False)],
                 writes=[Access(out, (idx("n"), idx("c")), True)],
                 op="pool", flops_per_iter=1.0,
                 spec=OpSpec("mean", (x,), (out,), {"axes": (2, 3)}))
        self.g.add_task(t)
        return out

    def mean_all(self, x: str) -> str:
        """Full mean-reduction to a (1, 1) scalar carrier — the loss head
        of traced training objectives."""
        shp = self.shape[x]
        if len(shp) < 2:
            raise TraceError(f"mean_all needs a rank>=2 operand (got {shp})")
        out = self.buf(self.fresh("loss"), (1, 1))
        dims = [f"i{k}" for k in range(len(shp))]
        t = Task(self.fresh("mean_all_t"),
                 loops=[Loop(d, int(n)) for d, n in zip(dims, shp)],
                 reads=[Access(x, full_index(dims), False)],
                 writes=[Access(out, (idx((dims[0], 0)), idx((dims[1], 0))),
                                True)],
                 op="pool", flops_per_iter=1.0,
                 spec=OpSpec("mean_all", (x,), (out,)))
        self.g.add_task(t)
        return out

    def flatten(self, x: str) -> str:
        n, c, h, w = self.shape[x]
        out = self.buf(self.fresh("flat"), (n, c * h * w))
        t = Task(self.fresh("flatten_t"),
                 loops=[Loop("n", n), Loop("c", c), Loop("h", h), Loop("w", w)],
                 reads=[Access(x, full_index(["n", "c", "h", "w"]), False)],
                 writes=[Access(out, (idx("n"),
                                      idx(("c", h * w), ("h", w), "w")), True)],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("reshape", (x,), (out,), {"shape": (n, -1)}))
        self.g.add_task(t)
        return out

    # ---- dense ops ---------------------------------------------------------

    def fc(self, x: str, dout: str | int, relu: bool = False,
           weight: str | None = None) -> str:
        m, k = self.shape[x]
        nname = int(dout)
        wname = weight or self.weight(self.fresh("wfc"), (k, nname))
        out = self.buf(self.fresh("fc"), (m, nname))
        self.g.add_task(matmul_task(
            self.fresh("fc_t"), out, x, wname, m, nname, k,
            spec=OpSpec("matmul", (x, wname), (out,))))
        if relu:
            out = self.relu(out)
        return out

    def matmul(self, a: str, b: str) -> str:
        """2-D ``(M, K) @ (K, N)`` or batched 3-D ``(B, M, K) @ (B, K, N)``
        (one leading batch dim; the batch loop prefixes all three
        accesses)."""
        sa, sb = self.shape[a], self.shape[b]
        if len(sa) == 3 or len(sb) == 3:
            if len(sa) != 3 or len(sb) != 3:
                raise TraceError(
                    f"batched matmul needs two 3-D operands (got {sa} and "
                    f"{sb}); lift the 2-D side explicitly")
            bt, m, k = sa
            bt2, k2, n = sb
            if bt != bt2 or k != k2:
                raise TraceError(f"batched matmul shape mismatch: {sa} @ {sb}")
            out = self.buf(self.fresh("bmm"), (bt, m, n))
            self.g.add_task(matmul_task(
                self.fresh("bmm_t"), out, a, b, m, n, k, batch=bt,
                spec=OpSpec("matmul", (a, b), (out,))))
            return out
        m, k = sa
        k2, n = sb
        assert k == k2, (sa, sb)
        out = self.buf(self.fresh("mm"), (m, n))
        self.g.add_task(matmul_task(
            self.fresh("mm_t"), out, a, b, m, n, k,
            spec=OpSpec("matmul", (a, b), (out,))))
        return out

    def transpose(self, x: str) -> str:
        """2-D transpose, or a last-two-dims swap for 3-D (batched)
        operands (spec attr ``perm=(0, 2, 1)``)."""
        shp = self.shape[x]
        if len(shp) == 3:
            bt, m, n = shp
            out = self.buf(self.fresh("tr"), (bt, n, m))
            t = Task(self.fresh("transpose_t"),
                     loops=[Loop("b", bt), Loop("i", m), Loop("j", n)],
                     reads=[Access(x, (idx("b"), idx("i"), idx("j")), False)],
                     writes=[Access(out, (idx("b"), idx("j"), idx("i")), True)],
                     op="copy", flops_per_iter=0.0,
                     spec=OpSpec("transpose", (x,), (out,),
                                 {"perm": (0, 2, 1)}))
            self.g.add_task(t)
            return out
        m, n = shp
        out = self.buf(self.fresh("tr"), (n, m))
        t = Task(self.fresh("transpose_t"),
                 loops=[Loop("i", m), Loop("j", n)],
                 reads=[Access(x, (idx("i"), idx("j")), False)],
                 writes=[Access(out, (idx("j"), idx("i")), True)],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("transpose", (x,), (out,)))
        self.g.add_task(t)
        return out

    def softmax(self, x: str) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("sm"), shp)
        self.g.add_task(ewise_task(
            self.fresh("softmax_t"), out, [x], shp, op="softmax",
            flops_per_iter=5.0,
            spec=OpSpec("softmax", (x,), (out,), {"axis": -1})))
        return out

    def scale(self, x: str, s: float) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("scale"), shp)
        # The scale factor is an OpSpec attr — plain data that enters
        # structural_signature(), so graphs differing only in `s` key the
        # compile cache apart (no const: tag needed, unlike closures).
        self.g.add_task(ewise_task(
            self.fresh("scale_t"), out, [x], shp, op="ewise",
            spec=OpSpec("scale", (x,), (out,), {"s": float(s)})))
        return out

    def mv(self, A: str, x: str, trans: bool = False) -> str:
        """y = A @ x (or A.T @ x): PolyBench building block."""
        m, k = self.shape[A]
        if trans:
            m, k = k, m
        out = self.buf(self.fresh("mv"), (m,))
        loops = [Loop("m", m), Loop("k", k)]
        a_idx = (idx("k"), idx("m")) if trans else (idx("m"), idx("k"))
        t = Task(self.fresh("mv_t"), loops,
                 reads=[Access(A, a_idx, False), Access(x, (idx("k"),), False)],
                 writes=[Access(out, (idx("m"),), True)],
                 op="matmul", flops_per_iter=2.0,
                 spec=OpSpec("mv", (A, x), (out,), {"trans": bool(trans)}))
        self.g.add_task(t)
        return out

    def load(self, x: str) -> str:
        """Explicit off-chip→on-chip stream task (the DMA 'load' node every
        HLS dataflow design starts with).  Makes downstream skip connections
        read an *intermediate* buffer, exercising the bypass pattern."""
        shp = self.shape[x]
        out = self.buf(self.fresh("ld"), shp)
        dims = ["n", "c", "h", "w"][:len(shp)] if len(shp) == 4 else None
        self.g.add_task(ewise_task(
            self.fresh("load_t"), out, [x], shp, op="copy", flops_per_iter=0.0,
            spec=OpSpec("identity", (x,), (out,)), dim_names=dims))
        return out

    def vadd(self, a: str, b: str, alpha: float = 1.0, beta: float = 1.0) -> str:
        shp = self.shape[a]
        out = self.buf(self.fresh("vadd"), shp)
        # alpha/beta are structural via OpSpec.attrs (see scale()).
        self.g.add_task(ewise_task(
            self.fresh("vadd_t"), out, [a, b], shp, op="ewise",
            spec=OpSpec("vadd", (a, b), (out,),
                        {"alpha": float(alpha), "beta": float(beta)})))
        return out

    def affine(self, x: str, a: float, b: float) -> str:
        """``a*x + b`` — scalar-operand add/sub (reflected-operator sugar)."""
        shp = self.shape[x]
        out = self.buf(self.fresh("affine"), shp)
        self.g.add_task(ewise_task(
            self.fresh("affine_t"), out, [x], shp, op="ewise",
            spec=OpSpec("affine", (x,), (out,),
                        {"a": float(a), "b": float(b)})))
        return out

    def divc(self, x: str, c: float) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("divc"), shp)
        self.g.add_task(ewise_task(
            self.fresh("divc_t"), out, [x], shp, op="ewise", flops_per_iter=4.0,
            spec=OpSpec("divc", (x,), (out,), {"c": float(c)})))
        return out

    def rdivc(self, x: str, c: float) -> str:
        shp = self.shape[x]
        out = self.buf(self.fresh("rdivc"), shp)
        self.g.add_task(ewise_task(
            self.fresh("rdivc_t"), out, [x], shp, op="ewise", flops_per_iter=4.0,
            spec=OpSpec("rdivc", (x,), (out,), {"c": float(c)})))
        return out

    def div(self, a: str, b: str) -> str:
        shp = self.shape[a]
        out = self.buf(self.fresh("div"), shp)
        self.g.add_task(ewise_task(
            self.fresh("div_t"), out, [a, b], shp, op="ewise", flops_per_iter=4.0,
            spec=OpSpec("div", (a, b), (out,))))
        return out

    def mul(self, a: str, b: str) -> str:
        shp = self.shape[a]
        out = self.buf(self.fresh("mul"), shp)
        self.g.add_task(ewise_task(
            self.fresh("mul_t"), out, [a, b], shp, op="ewise",
            spec=OpSpec("mul", (a, b), (out,))))
        return out

    def const(self, value) -> str:
        """A compile-time constant array as a producer task (array-left
        operands lifted into the trace)."""
        arr = np.asarray(value)
        if arr.dtype == object:
            raise TraceError(f"cannot lift {type(value).__name__} into a "
                             "trace as a constant array")
        arr = arr.astype(np.float32) if arr.dtype.kind in "fiu" else arr
        out = self.buf(self.fresh("const"), arr.shape)
        dims = [f"d{i}" for i in range(max(arr.ndim, 1))]
        t = Task(self.fresh("const_t"),
                 loops=[Loop(d, int(n)) for d, n in
                        zip(dims, arr.shape or (1,))],
                 reads=[],
                 writes=[Access(out, full_index(dims[:arr.ndim]), True)],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("const", (), (out,),
                             {"value": arr.tolist(), "dtype": arr.dtype.name,
                              "shape": arr.shape}))
        self.g.add_task(t)
        return out

    # ---- shape algebra -----------------------------------------------------

    def concat(self, xs: Sequence[str], axis: int = 0) -> str:
        """Concatenate along ``axis``; all other dims must agree."""
        shapes = [self.shape[x] for x in xs]
        if not xs:
            raise TraceError("concat needs at least one operand")
        rank = len(shapes[0])
        axis = axis % rank
        for s in shapes[1:]:
            if len(s) != rank or any(a != b for d, (a, b)
                                     in enumerate(zip(shapes[0], s))
                                     if d != axis):
                raise TraceError(f"concat operand shapes disagree off axis "
                                 f"{axis}: {shapes}")
        oshape = list(shapes[0])
        oshape[axis] = sum(s[axis] for s in shapes)
        out = self.buf(self.fresh("cat"), tuple(oshape))
        dims = [f"i{k}" for k in range(rank)]
        t = Task(self.fresh("concat_t"),
                 loops=[Loop(d, int(n)) for d, n in zip(dims, oshape)],
                 reads=[Access(x, full_index(dims), False) for x in xs],
                 writes=[Access(out, full_index(dims), True)],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("concat", tuple(xs), (out,), {"axis": axis}))
        self.g.add_task(t)
        return out

    def split(self, x: str, sizes: Sequence[int], axis: int = 0) -> tuple[str, ...]:
        """Partition ``axis`` into ``sizes`` pieces (the inverse of
        :meth:`concat`); one multi-output task, one buffer per piece."""
        shp = self.shape[x]
        axis = axis % len(shp)
        sizes = tuple(int(s) for s in sizes)
        if sum(sizes) != shp[axis] or any(s <= 0 for s in sizes):
            raise TraceError(f"split sizes {sizes} do not partition axis "
                             f"{axis} of shape {shp}")
        outs = []
        for s in sizes:
            oshape = list(shp)
            oshape[axis] = s
            outs.append(self.buf(self.fresh("sp"), tuple(oshape)))
        dims = [f"i{k}" for k in range(len(shp))]
        t = Task(self.fresh("split_t"),
                 loops=[Loop(d, int(n)) for d, n in zip(dims, shp)],
                 reads=[Access(x, full_index(dims), False)],
                 writes=[Access(o, full_index(dims), True) for o in outs],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("split", (x,), tuple(outs),
                             {"axis": axis, "sizes": sizes}))
        self.g.add_task(t)
        return tuple(outs)

    def slice(self, x: str, starts: Sequence[int],
              sizes: Sequence[int]) -> str:
        """Static rectangular window ``x[starts : starts + sizes]``."""
        shp = self.shape[x]
        starts = tuple(int(s) for s in starts)
        sizes = tuple(int(s) for s in sizes)
        if len(starts) != len(shp) or len(sizes) != len(shp):
            raise TraceError(f"slice needs one (start, size) per dim of "
                             f"{shp}; got starts={starts} sizes={sizes}")
        for st, sz, n in zip(starts, sizes, shp):
            if st < 0 or sz <= 0 or st + sz > n:
                raise TraceError(f"slice window starts={starts} "
                                 f"sizes={sizes} exceeds shape {shp}")
        out = self.buf(self.fresh("slc"), sizes)
        dims = [f"i{k}" for k in range(len(shp))]
        t = Task(self.fresh("slice_t"),
                 loops=[Loop(d, int(n)) for d, n in zip(dims, sizes)],
                 reads=[Access(x, full_index(dims), False)],
                 writes=[Access(out, full_index(dims), True)],
                 op="copy", flops_per_iter=0.0,
                 spec=OpSpec("slice", (x,), (out,),
                             {"starts": starts, "sizes": sizes}))
        self.g.add_task(t)
        return out

    # ---- recurrences -------------------------------------------------------

    def rglru_scan(self, a: str, b: str) -> str:
        """RG-LRU linear recurrence h_t = a_t*h_{t-1} + b_t over axis 1 of
        (B, S, D) operands — the scan-style recurrence op."""
        sa, sb = self.shape[a], self.shape[b]
        if sa != sb or len(sa) != 3:
            raise TraceError(f"rglru_scan needs matching (B, S, D) operands "
                             f"(got {sa} and {sb})")
        out = self.buf(self.fresh("scan"), sa)
        self.g.add_task(ewise_task(
            self.fresh("rglru_scan_t"), out, [a, b], sa, op="scan",
            flops_per_iter=2.0,
            spec=OpSpec("rglru_scan", (a, b), (out,))))
        return out

    def ssd_scan(self, states: str, decay: str) -> str:
        """SSD inter-chunk state recurrence over per-chunk end states
        (nc, BH, P, N) and decays (nc, BH, 1, 1); emits carried-in
        states."""
        ss, sd = self.shape[states], self.shape[decay]
        if len(ss) != 4 or len(sd) != 4 or sd[:2] != ss[:2] or sd[2:] != (1, 1):
            raise TraceError(f"ssd_scan needs (nc, BH, P, N) states and "
                             f"(nc, BH, 1, 1) decay (got {ss} and {sd})")
        out = self.buf(self.fresh("scan"), ss)
        dims = ["c", "h", "p", "n"]
        t = Task(self.fresh("ssd_scan_t"),
                 loops=[Loop(d, int(n)) for d, n in zip(dims, ss)],
                 reads=[Access(states, full_index(dims), False),
                        Access(decay, (idx("c"), idx("h"), idx(("p", 0)),
                                       idx(("n", 0))), False)],
                 writes=[Access(out, full_index(dims), True)],
                 op="scan", flops_per_iter=2.0,
                 spec=OpSpec("ssd_scan", (states, decay), (out,)))
        self.g.add_task(t)
        return out


# --------------------------------------------------------------------------
# Symbolic values
# --------------------------------------------------------------------------


@dataclass
class ShapedBuffer:
    """A symbolic tensor: shape + dtype, optionally bound to a live trace.

    Unbound instances (``tracer is None``) are *argument prototypes* —
    plain data, picklable, usable as ``codo.compile(fn, ShapedBuffer((4,
    8)))`` specs.  Bound instances flow through a traced function; every op
    applied to one records a task in the underlying graph.
    """

    shape: tuple[int, ...]
    dtype: Any = np.float32
    name: str | None = None
    tracer: "Tracer | None" = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # numpy must not try to coerce a ShapedBuffer into an object array:
    # returning NotImplemented from its ufuncs hands `ndarray <op> buffer`
    # expressions to the reflected methods below.
    __array_ufunc__ = None

    # Convenience operator sugar — traced functions read like the math.
    # Scalar and array-left operands are handled by the op functions
    # (scalars become affine/divc/rdivc attrs, arrays lift to const
    # tasks), so every reflected form stays bit-exact with eager mode.
    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return sub(self, other)

    def __rsub__(self, other):
        return sub(other, self)

    def __matmul__(self, other):
        return matmul(self, other)

    def __rmatmul__(self, other):
        return matmul(other, self)

    def __mul__(self, other):
        return mul(self, other)

    def __rmul__(self, other):
        return mul(other, self)

    def __truediv__(self, other):
        return div(self, other)

    def __rtruediv__(self, other):
        return div(other, self)

    @property
    def T(self):  # noqa: N802 — numpy's spelling
        return transpose(self)

    def relu(self):
        return relu(self)


def buffer(shape: Sequence[int], dtype=np.float32,
           name: str | None = None) -> ShapedBuffer:
    """An input-argument prototype for :func:`trace` / ``codo.compile``."""
    return ShapedBuffer(tuple(shape), dtype, name)


# --------------------------------------------------------------------------
# Tracer
# --------------------------------------------------------------------------


class Tracer:
    """Records a function's op calls into a :class:`GB` builder."""

    def __init__(self, name: str):
        self.gb = GB(name)
        self.inputs: list[str] = []
        self.outputs: list[str] = []

    # ---- binding -----------------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int],
                  dtype=np.float32) -> ShapedBuffer:
        self.gb.input(name, tuple(shape))
        self.gb.g.buffers[name].dtype = dtype
        self.inputs.append(name)
        return self.wrap(name)

    def wrap(self, bufname: str) -> ShapedBuffer:
        return ShapedBuffer(self.gb.shape[bufname],
                            self.gb.g.buffers[bufname].dtype,
                            name=bufname, tracer=self)

    def name_of(self, x: "ShapedBuffer") -> str:
        if not isinstance(x, ShapedBuffer) or x.tracer is None:
            raise TraceError(
                f"expected a traced ShapedBuffer, got {type(x).__name__}; "
                "inside a traced function every tensor must flow from the "
                "function's arguments")
        if x.tracer is not self:
            raise TraceError(
                f"buffer {x.name!r} belongs to a different trace "
                f"({x.tracer.gb.g.name!r}, this trace is {self.gb.g.name!r})")
        return x.name

    def finish(self, result) -> DataflowGraph:
        outs = result if isinstance(result, (tuple, list)) else (result,)
        if not outs:
            raise TraceError("traced function returned no buffers")
        for o in outs:
            name = self.name_of(o)
            if self.gb.g.buffers[name].kind == "input":
                raise TraceError(
                    f"traced function returns input {name!r} unchanged; "
                    "return a computed buffer (wrap pass-throughs in load())")
            if name in self.outputs:
                raise TraceError(f"buffer {name!r} returned more than once")
            self.gb.mark_output(name)
            self.outputs.append(name)
        self.gb.g.validate()
        return self.gb.g


def _positional_params(fn) -> list[str]:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return []
    return [p.name for p in sig.parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)]


def trace_io(fn: Callable, *specs, name: str | None = None,
             dtype=np.float32) -> tuple[DataflowGraph, list[str], list[str]]:
    """Trace ``fn`` over argument ``specs`` (shape tuples or
    :class:`ShapedBuffer` prototypes).  Returns ``(graph, input_names,
    output_names)`` — the io lists preserve the function's argument and
    return order, which is what gives ``CompiledProgram`` its positional
    calling convention."""
    if not callable(fn):
        raise TraceError(f"trace() needs a callable, got {type(fn).__name__}")
    if not specs:
        raise TraceError("trace() needs at least one input shape, e.g. "
                         "trace(fn, (64, 512))")
    tr = Tracer(name or getattr(fn, "__name__", "traced"))
    params = _positional_params(fn)
    args = []
    for i, spec in enumerate(specs):
        if isinstance(spec, ShapedBuffer):
            shape, dt, pname = spec.shape, spec.dtype, spec.name
        elif isinstance(spec, (tuple, list)):
            shape, dt, pname = tuple(spec), dtype, None
        else:
            raise TraceError(
                f"argument spec {i} must be a shape tuple or ShapedBuffer, "
                f"got {type(spec).__name__}")
        pname = pname or (params[i] if i < len(params) else f"arg{i}")
        args.append(tr.add_input(pname, shape, dt))
    return tr.gb.g, tr.inputs[:], _finish(tr, fn, args)


def _finish(tr: Tracer, fn: Callable, args: list[ShapedBuffer]) -> list[str]:
    tr.finish(fn(*args))
    return tr.outputs[:]


def trace(fn: Callable, *specs, name: str | None = None,
          dtype=np.float32) -> DataflowGraph:
    """Trace ``fn`` into a :class:`DataflowGraph` (see :func:`trace_io`)."""
    graph, _ins, _outs = trace_io(fn, *specs, name=name, dtype=dtype)
    return graph


# --------------------------------------------------------------------------
# Deterministic eager initialization.  Weights created *inside* an op (fc,
# conv) have no graph buffer to bind against in eager mode, so their values
# are a pure function of shape: fan-in-normalized, seeded from the shape
# itself.  CompiledProgram uses the same function for unbound weight
# buffers, which is what makes `codo.compile(fn)(x) == fn(x)` exact.  Two
# weights of identical shape share values by design — acceptable for
# verification; bind real parameters via CompiledProgram.bind().
# --------------------------------------------------------------------------


def weight_init(shape: Sequence[int], dtype=np.float32) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    seed = zlib.adler32(repr(shape).encode())
    rng = np.random.default_rng(seed)
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else (shape[0] if shape else 1)
    std = 1.0 / np.sqrt(max(fan_in, 1))
    return (rng.standard_normal(shape) * std).astype(dtype)


def _as_tensors(arrays) -> list:
    """Eager operands as tensors: numpy arrays move to the device and dtype
    of the first tensor operand (CPU and their own dtype when there is
    none); tensors pass through untouched."""
    import torch
    like = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif like is not None:
            out.append(torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                       device=like.device))
        else:
            out.append(torch.as_tensor(np.asarray(a)))
    return out


def _eager(kind: str, arrays, attrs: dict | None = None):
    ins = tuple(f"in{i}" for i in range(len(arrays)))
    spec = OpSpec(kind, ins, ("out",), dict(attrs or {}))
    return materialize(spec)(dict(zip(ins, _as_tensors(arrays))))["out"]


def _tracer_of(*values) -> Tracer | None:
    tr = None
    for v in values:
        if isinstance(v, ShapedBuffer) and v.tracer is not None:
            if tr is not None and v.tracer is not tr:
                raise TraceError("operands belong to different traces")
            tr = v.tracer
    return tr


def _as_scalar(v):
    """``v`` as a Python float if it is scalar-like (Python number, numpy
    scalar, 0-d array), else ``None``."""
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float, np.integer, np.floating)):
        return float(v)
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return float(v)
    return None


def _lift(tr: Tracer, v) -> str:
    """Buffer name of operand ``v`` inside trace ``tr``: traced buffers
    pass through, concrete arrays become ``const`` producer tasks."""
    if isinstance(v, ShapedBuffer):
        return tr.name_of(v)
    return tr.gb.const(v)


def _lift_ewise(tr: Tracer, a, b) -> tuple[str, str]:
    na, nb = _lift(tr, a), _lift(tr, b)
    sa, sb = tr.gb.shape[na], tr.gb.shape[nb]
    if sa != sb:
        raise TraceError(
            f"elementwise operands must have identical shapes inside a "
            f"trace (got {sa} and {sb}; broadcasting is not part of the "
            "dataflow IR)")
    return na, nb


# --------------------------------------------------------------------------
# The op namespace.  Each function dispatches: symbolic operands record a
# task through GB (identical structure to hand-built graphs), concrete
# arrays execute the registered reference implementation eagerly.
# --------------------------------------------------------------------------


def pad(x, p: int, pair: bool = False):
    """Zero-pad NCHW by ``p``.  ``pair=True`` emits the init/fill
    *multi-producer* form (Fig. 4b) instead of one pad task."""
    tr = _tracer_of(x)
    if tr is not None:
        emit = tr.gb.pad_pair if pair else tr.gb.pad
        return tr.wrap(emit(tr.name_of(x), p))
    # Both eager forms reduce to the same padded array (the pair's two
    # registered impls compose to exactly this).
    return _eager("pad2d", (x,), {"pad": p})


def conv(x, co: int, k: int, stride: int = 1, pad: int = -1,
         relu: bool = True, depthwise: bool = False):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.conv(tr.name_of(x), co, k, stride=stride,
                                  pad=pad, relu=relu, depthwise=depthwise))
    if pad < 0:
        pad = k // 2
    if pad:
        x = _eager("pad2d", (x,), {"pad": pad})
    ci = x.shape[1]
    groups = ci if depthwise else 1
    co_eff = ci if depthwise else co
    w = weight_init((co_eff, 1 if depthwise else ci, k, k))
    y = _eager("conv2d", (x, w), {"stride": stride, "groups": groups})
    return _eager("relu", (y,)) if relu else y


def relu(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.relu(tr.name_of(x)))
    return _eager("relu", (x,))


def gelu(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.gelu(tr.name_of(x)))
    return _eager("gelu", (x,))


def add(a, b):
    tr = _tracer_of(a, b)
    if tr is None:
        return _eager("add", (a, b))
    for x, c in ((a, _as_scalar(b)), (b, _as_scalar(a))):
        if c is not None:                    # x + c == c + x, bit-exact
            return tr.wrap(tr.gb.affine(tr.name_of(x), 1.0, c))
    return tr.wrap(tr.gb.add(*_lift_ewise(tr, a, b)))


def sub(a, b):
    tr = _tracer_of(a, b)
    if tr is None:
        return _eager("vadd", (a, b), {"alpha": 1.0, "beta": -1.0})
    c = _as_scalar(b)
    if c is not None:                        # x - c == x + (-c), bit-exact
        return tr.wrap(tr.gb.affine(tr.name_of(a), 1.0, -c))
    c = _as_scalar(a)
    if c is not None:                        # c - x == (-x) + c, bit-exact
        return tr.wrap(tr.gb.affine(tr.name_of(b), -1.0, c))
    return tr.wrap(tr.gb.vadd(*_lift_ewise(tr, a, b), alpha=1.0, beta=-1.0))


def mul(a, b):
    tr = _tracer_of(a, b)
    if tr is None:
        return _eager("mul", (a, b))
    for x, c in ((a, _as_scalar(b)), (b, _as_scalar(a))):
        if c is not None:                    # x * c == c * x, bit-exact
            return tr.wrap(tr.gb.scale(tr.name_of(x), c))
    return tr.wrap(tr.gb.mul(*_lift_ewise(tr, a, b)))


def div(a, b):
    tr = _tracer_of(a, b)
    if tr is None:
        return _eager("div", (a, b))
    c = _as_scalar(b)
    if c is not None:                        # true division, not 1/c scale
        return tr.wrap(tr.gb.divc(tr.name_of(a), c))
    c = _as_scalar(a)
    if c is not None:
        return tr.wrap(tr.gb.rdivc(tr.name_of(b), c))
    return tr.wrap(tr.gb.div(*_lift_ewise(tr, a, b)))


def vadd(a, b, alpha: float = 1.0, beta: float = 1.0):
    tr = _tracer_of(a, b)
    if tr is not None:
        return tr.wrap(tr.gb.vadd(tr.name_of(a), tr.name_of(b),
                                  alpha=alpha, beta=beta))
    return _eager("vadd", (a, b), {"alpha": float(alpha), "beta": float(beta)})


def scale(x, s: float):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.scale(tr.name_of(x), float(s)))
    return _eager("scale", (x,), {"s": float(s)})


def softmax(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.softmax(tr.name_of(x)))
    return _eager("softmax", (x,), {"axis": -1})


def matmul(a, b):
    tr = _tracer_of(a, b)
    if tr is not None:
        # Array operands (W @ x with a concrete W) lift to const tasks.
        return tr.wrap(tr.gb.matmul(_lift(tr, a), _lift(tr, b)))
    return _eager("matmul", (a, b))


def mv(A, x, trans: bool = False):
    tr = _tracer_of(A, x)
    if tr is not None:
        return tr.wrap(tr.gb.mv(tr.name_of(A), tr.name_of(x), trans=trans))
    return _eager("mv", (A, x), {"trans": bool(trans)})


def transpose(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.transpose(tr.name_of(x)))
    if getattr(x, "ndim", 2) == 3:       # batched: swap the last two dims
        return _eager("transpose", (x,), {"perm": (0, 2, 1)})
    return _eager("transpose", (x,))


def fc(x, dout: int, relu: bool = False, weight=None):
    tr = _tracer_of(x, weight if isinstance(weight, ShapedBuffer) else None)
    if tr is not None:
        wname = tr.name_of(weight) if isinstance(weight, ShapedBuffer) else weight
        return tr.wrap(tr.gb.fc(tr.name_of(x), dout, relu=relu, weight=wname))
    w = weight if weight is not None else weight_init((x.shape[1], int(dout)))
    y = _eager("matmul", (x, w))
    return _eager("relu", (y,)) if relu else y


def maxpool(x, k: int):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.maxpool(tr.name_of(x), k))
    return _eager("maxpool2d", (x,), {"k": k})


def global_avgpool(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.global_avgpool(tr.name_of(x)))
    return _eager("mean", (x,), {"axes": (2, 3)})


def flatten(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.flatten(tr.name_of(x)))
    return _eager("reshape", (x,), {"shape": (x.shape[0], -1)})


def mean_all(x):
    """Mean of every element as a (1, 1) scalar carrier — the loss head
    traced training objectives end in."""
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.mean_all(tr.name_of(x)))
    return _eager("mean_all", (x,))


def load(x):
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.load(tr.name_of(x)))
    return _eager("identity", (x,))


def concat(xs, axis: int = 0):
    """Concatenate a sequence of same-rank tensors along ``axis``."""
    xs = tuple(xs)
    tr = _tracer_of(*xs)
    if tr is not None:
        return tr.wrap(tr.gb.concat([_lift(tr, x) for x in xs], axis=axis))
    return _eager("concat", xs, {"axis": int(axis)})


def split(x, sizes, axis: int = 0):
    """Partition ``axis`` into ``len(sizes)`` pieces; inverse of
    :func:`concat`.  Returns a tuple of tensors."""
    sizes = tuple(int(s) for s in sizes)
    tr = _tracer_of(x)
    if tr is not None:
        return tuple(tr.wrap(o) for o in
                     tr.gb.split(tr.name_of(x), sizes, axis=axis))
    # Eager multi-output: _eager() is single-out, so build the spec inline.
    outs = tuple(f"out{i}" for i in range(len(sizes)))
    spec = OpSpec("split", ("in0",), outs,
                  {"axis": int(axis), "sizes": sizes})
    res = materialize(spec)({"in0": _as_tensors((x,))[0]})
    return tuple(res[o] for o in outs)


def slice_(x, starts, sizes):
    """Static window ``x[starts : starts + sizes]`` (one entry per dim)."""
    starts = tuple(int(s) for s in starts)
    sizes = tuple(int(s) for s in sizes)
    tr = _tracer_of(x)
    if tr is not None:
        return tr.wrap(tr.gb.slice(tr.name_of(x), starts, sizes))
    return _eager("slice", (x,), {"starts": starts, "sizes": sizes})


def rglru_scan(a, b):
    """Gated linear recurrence ``h_t = a_t * h_{t-1} + b_t`` along axis 1
    of ``(B, S, D)`` operands, ``h_{-1} = 0``."""
    tr = _tracer_of(a, b)
    if tr is not None:
        na, nb = _lift_ewise(tr, a, b)
        return tr.wrap(tr.gb.rglru_scan(na, nb))
    return _eager("rglru_scan", (a, b))


def ssd_scan(states, decay):
    """SSD inter-chunk recurrence: carried-in states per chunk from
    per-chunk end ``states (nc, BH, P, N)`` and ``decay (nc, BH, 1, 1)``."""
    tr = _tracer_of(states, decay)
    if tr is not None:
        return tr.wrap(tr.gb.ssd_scan(_lift(tr, states), _lift(tr, decay)))
    return _eager("ssd_scan", (states, decay))


# --------------------------------------------------------------------------
# Request coalescing (serving): rebuild a graph with a leading batch dim.
#
# The serving runtime (repro_torch.serving.runtime) coalesces same-signature
# requests arriving within one batching window into a single execution of
# a *batched* design: every buffer that depends on an input grows a
# leading dimension of size B, every touched task a leading batch loop.
# Weights (and const-producer chains) stay unbatched — the registered op
# implementations broadcast them per batch element, exactly like torch's
# leading-batch-dim convention for `@`, so the batched design computes
# what B independent runs compute.  It need not be bit for bit the same:
# a BLAS may pick another kernel, and so another summation order, for the
# B-times-taller product.
#
# The rebuild is *clean*: all schedule state (loop parallel degrees, access
# enclosing sets, buffer impls, fusion ids) is dropped, because the batched
# graph goes back through the full codo_opt pipeline — it is a new design,
# compiled and cached under its own structural hash.
# --------------------------------------------------------------------------

# Op kinds whose registered implementations are polymorphic over a leading
# batch dimension (elementwise broadcasting, `@`'s batch semantics, or an
# explicit attr rewrite below).  Graphs using anything else — conv2d's
# fixed NCHW layout, scans with a baked-in batch axis — fall back to
# per-request execution in the runtime.
BATCHABLE_KINDS = frozenset({
    "identity", "dup", "fused", "relu", "gelu", "add", "vadd", "scale",
    "affine", "divc", "rdivc", "div", "mul", "softmax", "matmul",
    "transpose",
})


def _batched_buffers(graph: DataflowGraph) -> set[str]:
    """Buffers that (transitively) depend on an input buffer — the ones a
    leading batch dim threads through.  Weights and const-producer chains
    stay unbatched (broadcasting lifts them per batch element)."""
    batched = {b.name for b in graph.inputs()}
    for t in graph.toposort():
        if any(a.buffer in batched for a in t.reads):
            batched.update(a.buffer for a in t.writes)
    return batched


def batch_blockers(graph: DataflowGraph) -> list[str]:
    """Why :func:`batch_graph` cannot coalesce this graph (empty = it can).

    A graph batches when every task touched by the batch dim carries a
    declarative spec built only from :data:`BATCHABLE_KINDS` and every
    output depends on an input.  The returned strings are human-readable
    reasons — the serving runtime records the first one when it falls back
    to per-request execution."""
    problems: list[str] = []
    batched = _batched_buffers(graph)
    missing = [b.name for b in graph.outputs() if b.name not in batched]
    if missing:
        problems.append(f"outputs {missing} do not depend on any input")

    def _walk(spec: OpSpec):
        yield spec
        for p in spec.parts:
            yield from _walk(p)

    for t in graph.tasks:
        if not any(a.buffer in batched for a in t.accesses()):
            continue                      # untouched by the batch dim
        if t.fn_is_closure:
            problems.append(f"task {t.name}: closure numerics cannot be "
                            "re-batched (no declarative spec)")
            continue
        if t.spec is None:
            problems.append(f"task {t.name}: no numeric semantics")
            continue
        for s in _walk(t.spec):
            if s.kind not in BATCHABLE_KINDS:
                problems.append(f"task {t.name}: op kind {s.kind!r} is not "
                                "batch-polymorphic")
    return problems


def _batch_spec(spec: OpSpec, batched: set[str]) -> OpSpec:
    """Copy of ``spec`` adjusted for a leading batch dim on the operands in
    ``batched``.  Most kinds need nothing (broadcasting does the work);
    ``transpose`` perms and non-negative ``softmax`` axes shift by one.
    Fused parts propagate batched-ness through their interior names."""
    out = spec.copy()
    if out.kind == "fused":
        inner = set(batched)
        parts = []
        for part in out.parts:
            parts.append(_batch_spec(part, inner))
            if any(b in inner for b in part.ins):
                inner.update(part.outs)
        out.parts = tuple(parts)
        return out
    if not any(b in batched for b in out.ins):
        return out
    if out.kind == "transpose":
        perm = out.attrs.get("perm")
        if perm is None:                       # 2-D .T -> batched (0, 2, 1)
            out.attrs["perm"] = (0, 2, 1)
        else:
            out.attrs["perm"] = (0,) + tuple(int(p) + 1 for p in perm)
    elif out.kind == "softmax":
        axis = int(out.attrs.get("axis", -1))
        if axis >= 0:
            out.attrs["axis"] = axis + 1
    return out


def batch_graph(graph: DataflowGraph, batch: int, *,
                name: str | None = None, var: str = "rb") -> DataflowGraph:
    """A clean rebuild of ``graph`` with a leading batch dimension of size
    ``batch`` on every input-dependent buffer (weights stay shared).

    The result is a fresh, schedule-free design — compile it through
    ``codo_torch.compile``/``codo_opt`` like any other graph; it caches under its
    own structural hash.  Raises :class:`TraceError` when
    :func:`batch_blockers` is non-empty or ``batch < 1``.
    """
    batch = int(batch)
    if batch < 1:
        raise TraceError(f"batch_graph needs batch >= 1, got {batch}")
    problems = batch_blockers(graph)
    if problems:
        raise TraceError(f"graph {graph.name!r} cannot take a leading "
                         f"batch dim: " + "; ".join(problems))
    batched = _batched_buffers(graph)
    out = DataflowGraph(name or f"{graph.name}@b{batch}")
    for b in graph.buffers.values():
        shape = ((batch,) + tuple(b.shape)) if b.name in batched \
            else tuple(b.shape)
        out.add_buffer(Buffer(b.name, shape, b.dtype, b.kind))
    for t in graph.tasks:
        loops = [Loop(l.var, l.trip) for l in t.loops]
        bvar = None
        if any(a.buffer in batched for a in t.accesses()):
            bvar = var
            used = {l.var for l in t.loops}
            while bvar in used:
                bvar += "_"
            loops = [Loop(bvar, batch)] + loops

        def _acc(a: Access) -> Access:
            index = tuple(tuple(dim) for dim in a.index)
            if a.buffer in batched:
                index = (idx(bvar),) + index
            return Access(a.buffer, index, a.is_write)

        spec = None
        if t.spec is not None:
            spec = (_batch_spec(t.spec, batched) if bvar is not None
                    else t.spec.copy())
        out.add_task(Task(
            t.name, loops, [_acc(a) for a in t.reads],
            [_acc(a) for a in t.writes], op=t.op,
            flops_per_iter=t.flops_per_iter,
            bytes_per_iter=t.bytes_per_iter, spec=spec, tags=set(t.tags)))
    out.validate()
    return out


__all__ = [
    "BATCHABLE_KINDS", "GB", "ShapedBuffer", "TraceError", "Tracer",
    "batch_blockers", "batch_graph", "buffer", "trace",
    "trace_io", "weight_init",
    # ops
    "add", "concat", "conv", "div", "fc", "flatten", "gelu",
    "global_avgpool", "load", "matmul", "maxpool", "mean_all", "mul", "mv",
    "pad", "relu", "rglru_scan", "scale", "slice_", "softmax", "split",
    "ssd_scan", "sub", "transpose", "vadd",
]
