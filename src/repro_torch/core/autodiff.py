"""Graph-level autodiff: the backward pass as a second dataflow graph.

The PyTorch port's copy of ``repro/core/autodiff.py``: the same
framework-free graph construction, so the backward and update graphs it
builds carry the reference's structural hashes.  Only the op bodies the
graphs run (``repro_torch.core.ops``) are torch code.

``build_backward`` walks a traced forward :class:`DataflowGraph` in
reverse topological order and, for every task, invokes the declarative
VJP rule registered for its ``OpSpec.kind`` (``core.ops.register_vjp``).
Rules emit plain spec'd tasks into a fresh graph through the builder
defined here — so the backward is a first-class dataflow graph: the same
PassManager presets (coarse/fine violation elimination, fusion,
cost-gated kernel routing) and the same compile cache apply to it
unchanged.  Streaming reuse is typically worth *more* in the backward,
where every matmul spawns two transposed re-reads of its forward
operands.

``build_update`` expresses the AdamW optimizer (global-norm clip, AdamW
update and the warmup-cosine learning rate of the reference's
``training/optimizer.py``, op for op) as registry ops (``sumsq``/
``clip_scale``/``lr_sched``/``adamw_step``) in a third graph, and
``build_train_graphs`` links all three: the forward copy re-marks the
backward's residual buffers as outputs so forward and backward share them
instead of recomputing.

Nothing here imports torch: rules and graph builders are plain data.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .frontend import GB
from .graph import Access, DataflowGraph, Loop, Task, full_index, idx
from .ops import OpSpec, UnknownOpError, vjp_rule

__all__ = ["AutodiffError", "BackwardBuild", "TrainGraphs", "DEFAULT_OPT",
           "build_backward", "build_train_graphs", "build_update",
           "opt_attrs"]


class AutodiffError(RuntimeError):
    """A graph (or one of its tasks) cannot be differentiated."""


# The exact field set of the reference's ``training.optimizer.OptConfig``
# (and of the port's ``repro_torch.training.optimizer.OptConfig``), as
# plain data, duplicated as in the reference so the compiler does not
# import the training package.
DEFAULT_OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
               "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 100,
               "total_steps": 10000, "min_lr_frac": 0.1}


def opt_attrs(oc=None) -> dict:
    """Normalize an optimizer config (``OptConfig``, dict, or None) to the
    plain attr dict the update-graph ops consume."""
    if oc is None:
        return dict(DEFAULT_OPT)
    if isinstance(oc, dict):
        unknown = set(oc) - set(DEFAULT_OPT)
        if unknown:
            raise AutodiffError(f"unknown optimizer fields: {sorted(unknown)}")
        return {**DEFAULT_OPT, **oc}
    if dataclasses.is_dataclass(oc):
        return {**DEFAULT_OPT,
                **{k: v for k, v in dataclasses.asdict(oc).items()
                   if k in DEFAULT_OPT}}
    return {k: getattr(oc, k, v) for k, v in DEFAULT_OPT.items()}


class _GradGB(GB):
    """GB whose generated names carry a ``d<n>_`` prefix — a namespace
    disjoint from any traced forward graph's buffers, so imported
    residuals (which keep their forward names) can never collide with
    generated cotangent buffers."""

    def fresh(self, prefix: str) -> str:
        self.n += 1
        return f"d{self.n}_{prefix}"


class _BwdBuilder:
    """The builder VJP rules receive.  Wraps a :class:`GB` (delegating the
    ops GB already knows how to index) plus a generalized ``emit`` for the
    gradient ops, and imports forward buffers as shared residuals."""

    def __init__(self, gb: GB, src: DataflowGraph | None = None):
        self.gb = gb
        self.src = src
        self.residuals: list[str] = []
        self._imported: set[str] = set()

    # ---- queries ---------------------------------------------------------
    def shape(self, name: str) -> tuple[int, ...]:
        shp = self.gb.shape.get(name)
        if shp is None and self.src is not None:
            shp = tuple(self.src.buffers[name].shape)
        if shp is None:
            raise AutodiffError(f"unknown buffer {name!r}")
        return tuple(shp)

    def res(self, name: str) -> str:
        """Import forward buffer ``name`` into the backward graph (as an
        input, under the *same* name — the residual the train step wires
        from the forward run).  Idempotent."""
        if name in self._imported:
            return name
        if name in self.gb.shape:
            raise AutodiffError(
                f"residual {name!r} collides with a generated backward "
                f"buffer")
        if self.src is None or name not in self.src.buffers:
            raise AutodiffError(f"residual {name!r} not in the source graph")
        buf = self.src.buffers[name]
        self.gb.buf(name, tuple(buf.shape), "input")
        self.gb.g.buffers[name].dtype = buf.dtype
        self._imported.add(name)
        self.residuals.append(name)
        return name

    # ---- GB delegation (ops whose loop indexing GB already handles) ------
    def add(self, a, b):
        return self.gb.add(a, b)

    def mul(self, a, b):
        return self.gb.mul(a, b)

    def div(self, a, b):
        return self.gb.div(a, b)

    def divc(self, x, c):
        return self.gb.divc(x, float(c))

    def scale(self, x, s):
        return self.gb.scale(x, float(s))

    def matmul(self, a, b):
        return self.gb.matmul(a, b)

    def transpose(self, x):
        return self.gb.transpose(x)

    def mv(self, A, x, trans=False):
        return self.gb.mv(A, x, trans=trans)

    def concat(self, xs, axis=0):
        return self.gb.concat(list(xs), axis)

    def split(self, x, sizes, axis=0):
        return self.gb.split(x, sizes, axis)

    def slice(self, x, starts, sizes):
        return self.gb.slice(x, starts, sizes)

    # ---- composite helpers ----------------------------------------------
    def add_n(self, xs):
        """Left fold of :meth:`add` — accumulates cotangent contributions."""
        xs = list(xs)
        if not xs:
            raise AutodiffError("add_n of zero contributions")
        acc = xs[0]
        for x in xs[1:]:
            acc = self.add(acc, x)
        return acc

    def outer(self, u: str, v: str) -> str:
        (m,), (n,) = self.shape(u), self.shape(v)
        gb = self.gb
        out = gb.buf(gb.fresh("outer"), (m, n))
        gb.g.add_task(Task(
            gb.fresh("outer_t"), [Loop("i", m), Loop("j", n)],
            reads=[Access(u, (idx("i"),), False), Access(v, (idx("j"),), False)],
            writes=[Access(out, (idx("i"), idx("j")), True)],
            op="matmul", flops_per_iter=1.0,
            spec=OpSpec("outer", (u, v), (out,))))
        return out

    def zeros(self, shape, name=None, kind="intermediate",
              dtype="float32") -> str:
        gb = self.gb
        shape = tuple(int(s) for s in shape)
        out = gb.buf(name or gb.fresh("zeros"), shape, kind)
        dims = [f"i{k}" for k in range(len(shape))]
        gb.g.add_task(Task(
            gb.fresh("zeros_t"), [Loop(d, s) for d, s in zip(dims, shape)],
            reads=[], writes=[Access(out, full_index(dims), True)],
            op="copy", flops_per_iter=0.0,
            spec=OpSpec("zeros", (), (out,),
                        {"shape": shape, "dtype": dtype})))
        return out

    def copy_to(self, name: str, src_buf: str, kind: str = "output") -> str:
        """Identity-copy ``src_buf`` into an explicitly named buffer (the
        ``grad_<w>`` outputs)."""
        gb = self.gb
        shp = self.shape(src_buf)
        gb.buf(name, shp, kind)
        dims = [f"i{k}" for k in range(len(shp))]
        gb.g.add_task(Task(
            gb.fresh("copy_t"), [Loop(d, int(s)) for d, s in zip(dims, shp)],
            reads=[Access(src_buf, full_index(dims), False)],
            writes=[Access(name, full_index(dims), True)],
            op="copy", flops_per_iter=0.0,
            spec=OpSpec("identity", (src_buf,), (name,))))
        return name

    def ewise(self, kind, ins, attrs=None, shape=None, flops=1.0) -> str:
        return self.emit(kind, ins, (shape or self.shape(ins[0]),),
                         attrs, op="ewise", flops=flops)[0]

    # ---- generalized emitter --------------------------------------------
    @staticmethod
    def _index(shape, dims, trips):
        """Access index over the leading ``min(rank, len(dims))`` loop
        vars; size-1 dims under a non-trivial loop read with coefficient 0
        (the broadcast/reduction-carrier convention ``ssd_scan`` and the
        (1, 1) optimizer scalars use)."""
        ix = []
        for d, (v, trip) in zip(shape, zip(dims, trips)):
            ix.append(idx((v, 0)) if d == 1 and trip != 1 else idx(v))
        return tuple(ix)

    def emit(self, kind, ins, out_shapes, attrs=None, op="ewise", flops=1.0,
             loop_shape=None, out_names=None) -> list[str]:
        """One spec'd task computing ``kind`` over ``ins`` into fresh (or
        explicitly named) output buffers.  The loop nest spans
        ``loop_shape`` (default: the first output's shape); operands of
        lower rank use the leading loop vars, so reductions to (1, 1)
        carriers express as coefficient-0 writes (the same write-inside-
        reduction shape ``matmul_task`` uses)."""
        gb = self.gb
        out_shapes = [tuple(int(s) for s in shp) for shp in out_shapes]
        names = out_names or (None,) * len(out_shapes)
        outs = tuple(gb.buf(nm or gb.fresh(kind), shp)
                     for nm, shp in zip(names, out_shapes))
        trips = tuple(int(s) for s in (loop_shape or out_shapes[0]))
        dims = [f"i{k}" for k in range(len(trips))]
        reads = [Access(b, self._index(self.shape(b), dims, trips), False)
                 for b in ins]
        writes = [Access(o, self._index(gb.shape[o], dims, trips), True)
                  for o in outs]
        gb.g.add_task(Task(
            gb.fresh(f"{kind}_t"), [Loop(d, t) for d, t in zip(dims, trips)],
            reads=reads, writes=writes, op=op, flops_per_iter=float(flops),
            spec=OpSpec(kind, tuple(ins), outs, dict(attrs or {}))))
        return list(outs)


# --------------------------------------------------------------------------
# Backward construction
# --------------------------------------------------------------------------


@dataclass
class BackwardBuild:
    """``build_backward``'s result: the backward graph plus the wiring
    tables the train step needs — ``seeds`` maps each forward output to
    its cotangent-seed input, ``residuals`` lists the forward buffers the
    backward reads (shared, not recomputed), ``grads`` maps each ``wrt``
    buffer to its ``grad_<w>`` output."""

    graph: DataflowGraph
    seeds: dict[str, str]
    residuals: list[str] = field(default_factory=list)
    grads: dict[str, str] = field(default_factory=dict)


def build_backward(src: DataflowGraph, *, wrt=None,
                   name: str | None = None) -> BackwardBuild:
    """Emit the VJP of ``src`` as a new dataflow graph.

    ``wrt`` defaults to the weight buffers.  The walk visits tasks in
    reverse topological order; every output is seeded with a
    ``seed_<out>`` input, per-buffer cotangent contributions accumulate
    through pairwise adds (memoized per buffer, so multi-producer buffers
    fold once), and each ``wrt`` buffer's total lands in a ``grad_<w>``
    output (zeros when no differentiable path reaches it)."""
    src.validate()
    if wrt is None:
        wrt = [b.name for b in src.weights()]
    wrt = list(wrt)
    gb = _GradGB(name or f"{src.name}_bwd")
    b = _BwdBuilder(gb, src)
    outputs = [buf.name for buf in src.outputs()]
    if not outputs:
        raise AutodiffError(f"{src.name}: no output buffers to seed")

    seeds: dict[str, str] = {}
    cot: dict[str, list[str]] = {}
    for o in outputs:
        s = gb.buf(f"seed_{o}", tuple(src.buffers[o].shape), "input")
        gb.g.buffers[s].dtype = src.buffers[o].dtype
        seeds[o] = s
        cot[o] = [s]

    combined: dict[str, str] = {}

    def fold(buf_name: str) -> str:
        if buf_name not in combined:
            combined[buf_name] = b.add_n(cot[buf_name])
        return combined[buf_name]

    for t in reversed(src.toposort()):
        spec = t.spec
        if spec is None:
            raise AutodiffError(
                f"{src.name}: task {t.name} has no OpSpec — only "
                f"spec-carrying graphs are differentiable")
        live = {o: fold(o) for o in spec.outs if cot.get(o)}
        if not live:
            continue
        if spec.kind == "fused":
            raise AutodiffError(
                f"{src.name}: task {t.name} is a fused composite — "
                f"differentiate the pre-pass source graph, then run "
                f"forward and backward through the pass pipeline")
        try:
            rule = vjp_rule(spec.kind)
        except UnknownOpError as e:
            raise AutodiffError(f"{src.name}: task {t.name}: {e}") from None
        contrib = rule(spec, live, b)
        pairs = contrib.items() if isinstance(contrib, dict) else contrib
        for in_name, c in pairs:
            if c is not None:
                cot.setdefault(in_name, []).append(c)

    grads: dict[str, str] = {}
    for w in wrt:
        if w not in src.buffers:
            raise AutodiffError(f"{src.name}: wrt buffer {w!r} not found")
        gname = f"grad_{w}"
        if cot.get(w):
            b.copy_to(gname, fold(w))
        else:
            b.zeros(tuple(src.buffers[w].shape), name=gname, kind="output")
        grads[w] = gname

    bwd = gb.g
    bwd.validate()
    return BackwardBuild(graph=bwd, seeds=seeds,
                         residuals=list(b.residuals), grads=grads)


# --------------------------------------------------------------------------
# AdamW update graph
# --------------------------------------------------------------------------

# Names the update graph claims for itself; parameters may not collide.
_RESERVED = ("step", "new_step", "lr", "grad_norm")
_RESERVED_PREFIXES = ("grad_", "m_", "v_", "new_")


def _loop_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """At least rank 2, so the (1, 1) scalar carriers index cleanly."""
    return shape if len(shape) >= 2 else shape + (1,) * (2 - len(shape))


def build_update(params: dict[str, tuple[int, ...]], oc=None,
                 name: str = "adamw_update") -> DataflowGraph:
    """The AdamW + global-norm-clip + LR-schedule update as one dataflow
    graph: inputs ``{w, grad_w, m_w, v_w}`` per parameter plus the (1, 1)
    ``step`` counter; outputs ``{new_w, new_m_w, new_v_w}`` plus the
    ``new_step``/``lr``/``grad_norm`` metric carriers.  Arithmetic is the
    eager ``optimizer.adamw_update`` op-for-op (square-sums accumulate in
    sorted parameter order, matching the reference's dict-key tree order)."""
    opt = opt_attrs(oc)
    for w in params:
        if w in _RESERVED or any(w.startswith(p) for p in _RESERVED_PREFIXES):
            raise AutodiffError(
                f"parameter name {w!r} collides with reserved update-graph "
                f"names ({_RESERVED} and prefixes {_RESERVED_PREFIXES})")
    gb = GB(name)
    b = _BwdBuilder(gb)
    step = gb.input("step", (1, 1))

    items = sorted((w, tuple(int(s) for s in shp))
                   for w, shp in params.items())
    nsqs = []
    for w, shp in items:
        gb.input(w, shp)
        gb.input(f"grad_{w}", shp)
        gb.input(f"m_{w}", shp)
        gb.input(f"v_{w}", shp)
        nsqs.append(b.emit("sumsq", (f"grad_{w}",), ((1, 1),), op="pool",
                           flops=2.0, loop_shape=_loop_shape(shp))[0])
    total = b.add_n(nsqs)
    scale, _ = b.emit("clip_scale", (total,), ((1, 1), (1, 1)),
                      {"max_norm": float(opt["clip_norm"])},
                      out_names=(None, "grad_norm"))
    step2 = b.emit("affine", (step,), ((1, 1),), {"a": 1.0, "b": 1.0})[0]
    lr = b.emit("lr_sched", (step2,), ((1, 1),),
                {"lr": float(opt["lr"]),
                 "warmup_steps": int(opt["warmup_steps"]),
                 "total_steps": int(opt["total_steps"]),
                 "min_lr_frac": float(opt["min_lr_frac"])})[0]
    b.copy_to("new_step", step2)
    b.copy_to("lr", lr)
    adam = {"b1": float(opt["b1"]), "b2": float(opt["b2"]),
            "eps": float(opt["eps"]), "wd": float(opt["weight_decay"])}
    for w, shp in items:
        b.emit("adamw_step",
               (w, f"grad_{w}", f"m_{w}", f"v_{w}", scale, lr, step2),
               (shp, shp, shp), adam,
               out_names=(f"new_{w}", f"new_m_{w}", f"new_v_{w}"),
               loop_shape=_loop_shape(shp))
        for o in (f"new_{w}", f"new_m_{w}", f"new_v_{w}"):
            gb.mark_output(o)
    gb.mark_output("grad_norm")
    g = gb.g
    g.validate()
    return g


# --------------------------------------------------------------------------
# Linked train-step graphs
# --------------------------------------------------------------------------


@dataclass
class TrainGraphs:
    """The three linked graphs of one training step plus their wiring:
    ``forward`` is the source with the backward's residual intermediates
    re-marked as outputs (shared buffers, not recomputation), ``loss`` is
    the single forward output, and ``params``/``seeds``/``residuals``/
    ``grads`` name the buffers the step threads between phases."""

    forward: DataflowGraph
    backward: DataflowGraph
    update: DataflowGraph
    loss: str
    seeds: dict[str, str]
    residuals: list[str]
    grads: dict[str, str]
    params: list[str]
    opt: dict


def build_train_graphs(src: DataflowGraph, *, oc=None, wrt=None,
                       name: str | None = None) -> TrainGraphs:
    """Differentiate ``src`` (single output = the loss) and link
    forward/backward/AdamW-update graphs for a full training step."""
    outs = src.outputs()
    if len(outs) != 1:
        raise AutodiffError(
            f"{src.name}: a train step needs exactly one (loss) output; "
            f"got {sorted(b.name for b in outs)}")
    loss = outs[0].name
    base = name or src.name
    bb = build_backward(src, wrt=wrt, name=f"{base}_bwd")
    fwd = src.copy()
    fwd.name = f"{base}_fwd"
    for r in bb.residuals:
        if fwd.buffers[r].kind == "intermediate":
            fwd.buffers[r].kind = "output"
    params = sorted(bb.grads)
    upd = build_update({w: tuple(src.buffers[w].shape) for w in params},
                       oc, name=f"{base}_upd")
    return TrainGraphs(forward=fwd, backward=bb.graph, update=upd,
                       loss=loss, seeds=bb.seeds, residuals=bb.residuals,
                       grads=bb.grads, params=params, opt=opt_attrs(oc))
