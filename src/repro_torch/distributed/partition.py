"""Mesh partitioning pass: assign every buffer a placement and derive the
collective events that keep the sharded execution numerically identical
to the single-device lowering.

The pass runs *after* ``codo_opt`` (the single-device pipeline output is
mesh-agnostic, so the compile cache stays shared across meshes) and works
by forward propagation over the task toposort — the same order the
lowered program executes in, which is what lets a "gather before task T"
event rewrite the live value exactly once:

* **data parallel** seeds every graph input with its leading dim sharded
  over the ``data`` axis and lets specs flow through elementwise ops.
* **tensor parallel** decides weight placement lazily at each matmul:
  an unsharded activation gets a column-sharded weight (output sharded
  over ``model``), a ``model``-sharded activation gets a row-sharded
  weight — whose contraction leaves *partial sums*, resolved by a psum
  emitted right after the producing task (the Megatron pairing falls out
  of propagation instead of being pattern-matched).
* every op the rules don't understand conservatively gathers its sharded
  operands first, which is always correct — just not free.  The cost
  model (:func:`repro_torch.core.costmodel.estimate_sharding`) prices those
  gathers against the per-shard compute win, and ``strategy="auto"``
  picks the cheapest feasible candidate.

The PyTorch port's copy of ``repro/distributed/partition.py``: the same
rules give the same plans, digests and ``estimated_cycles`` (priced by
the port's copy of the cost model).  The output is a pure-data
:class:`~repro_torch.distributed.plan.ShardingPlan`.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.core.costmodel import V5E, HwParams, estimate_sharding
from repro_torch.distributed import collectives as _coll
from repro_torch.distributed.plan import MeshSpec, ShardingPlan, ShardSpec

__all__ = ["PartitionError", "partition", "propagate", "STRATEGIES"]

STRATEGIES = ("replicate", "dp", "tp", "dp_tp", "auto")

_EWISE_UNARY = {"relu", "gelu", "scale", "affine", "divc", "rdivc",
                "identity"}
_EWISE_BINARY = {"add", "vadd", "mul", "div"}


class PartitionError(ValueError):
    """Unknown strategy, missing mesh axis, or an unshardable graph."""


def _dp_axis(mesh: MeshSpec) -> str:
    return "data" if "data" in mesh.names else mesh.names[0]


def _tp_axis(mesh: MeshSpec) -> str | None:
    if "model" in mesh.names:
        return "model"
    rest = [n for n in mesh.names if n != _dp_axis(mesh)]
    return rest[0] if rest else None


class _Prop:
    """Mutable propagation state: per-buffer dim assignments + events."""

    def __init__(self, graph, mesh: MeshSpec):
        self.graph = graph
        self.mesh = mesh
        self.dims: dict[str, list] = {}      # buffer -> [axis|None]*ndim
        self.events: list[dict] = []         # raw collective events

    def spec(self, name: str) -> list:
        if name not in self.dims:
            self.dims[name] = [None] * len(self.graph.buffers[name].shape)
        return self.dims[name]

    def divides(self, name: str, d: int, axis: str) -> bool:
        size = self.graph.buffers[name].shape[d]
        n = self.mesh.axis_size(axis)
        return n > 0 and size % n == 0 and size // n >= 1

    def gather(self, name: str, task: str, dims: Iterable[int] | None = None):
        """Replicate ``name`` (fully, or along ``dims``) before ``task``."""
        spec = self.spec(name)
        targets = range(len(spec)) if dims is None else dims
        for d in targets:
            if spec[d] is not None:
                self.events.append({"kind": "all_gather", "buffer": name,
                                    "axis": spec[d], "task": task,
                                    "where": "before", "dim": d})
                spec[d] = None

    def psum(self, name: str, axis: str, task: str):
        self.events.append({"kind": "psum", "buffer": name, "axis": axis,
                            "task": task, "where": "after", "dim": 0})


def _visit_matmul(st: _Prop, task, tp_axis: str | None):
    a, b = task.spec.ins
    out = task.spec.outs[0]
    sa = st.spec(a)

    # Lazy tensor-parallel weight placement (2-D weights only).
    bbuf = st.graph.buffers[b]
    if (tp_axis is not None and bbuf.kind == "weight"
            and b not in st.dims and len(bbuf.shape) == 2):
        sb = st.spec(b)
        if sa[-1] == tp_axis and st.divides(b, 0, tp_axis):
            sb[0] = tp_axis                        # row-parallel
        elif sa[-1] is None and st.divides(b, 1, tp_axis):
            sb[1] = tp_axis                        # column-parallel
    sb = st.spec(b)

    # Batched matmul: leading batch dims must agree shard-for-shard.
    nbatch = len(sa) - 2
    for d in range(nbatch):
        if sa[d] != sb[d]:
            st.gather(a, task.name, [d])
            st.gather(b, task.name, [d])

    # Contraction dims: both sharded the same way -> partial sums (psum
    # after the task); any mismatch -> gather the offending operand.
    ca, cb = sa[-1], sb[-2]
    partial = None
    if ca is not None and ca == cb:
        partial = ca
    else:
        if ca is not None:
            st.gather(a, task.name, [len(sa) - 1])
        if cb is not None:
            st.gather(b, task.name, [len(sb) - 2])

    # Output dims: a's rows, b's cols.  The same mesh axis cannot shard
    # two output dims — gather b's column sharding on conflict.
    om, on = sa[-2], sb[-1]
    if om is not None and om == on:
        st.gather(b, task.name, [len(sb) - 1])
        on = None
    batch = [sa[d] for d in range(nbatch)]
    for d, ax in enumerate(batch):
        if ax is not None and ax in (om, on):
            st.gather(a, task.name, [d])
            st.gather(b, task.name, [d])
            batch[d] = None
    st.dims[out] = batch + [om, on]
    if partial is not None:
        st.psum(out, partial, task.name)


def _visit(st: _Prop, task, tp_axis: str | None):
    spec = task.spec
    kind = spec.kind
    if kind == "matmul":
        _visit_matmul(st, task, tp_axis)
    elif kind in _EWISE_UNARY:
        st.dims[spec.outs[0]] = list(st.spec(spec.ins[0]))
    elif kind == "dup":
        # reuse-pass fanout: every copy inherits the source placement
        for o in spec.outs:
            st.dims[o] = list(st.spec(spec.ins[0]))
    elif kind in _EWISE_BINARY:
        a, b = spec.ins[0], spec.ins[1]
        sa, sb = st.spec(a), st.spec(b)
        ashape = st.graph.buffers[a].shape
        bshape = st.graph.buffers[b].shape
        if tuple(ashape) != tuple(bshape) or len(sa) != len(sb):
            st.gather(a, task.name)
            st.gather(b, task.name)
        else:
            for d in range(len(sa)):
                if sa[d] != sb[d]:
                    st.gather(a, task.name, [d])
                    st.gather(b, task.name, [d])
        st.dims[spec.outs[0]] = list(st.spec(a))
    elif kind == "transpose":
        x = spec.ins[0]
        sx = st.spec(x)
        perm = spec.attrs.get("perm")
        perm = tuple(int(p) for p in perm) if perm is not None \
            else tuple(reversed(range(len(sx))))
        st.dims[spec.outs[0]] = [sx[p] for p in perm]
    elif kind == "softmax":
        x = spec.ins[0]
        sx = st.spec(x)
        axis = int(spec.attrs.get("axis", -1)) % len(sx)
        if sx[axis] is not None:
            st.gather(x, task.name, [axis])
        st.dims[spec.outs[0]] = list(st.spec(x))
    elif kind in ("zeros", "const", "fill_interior"):
        for o in spec.outs:
            st.dims[o] = [None] * len(st.graph.buffers[o].shape)
    else:
        # Conservative fallback (conv2d, pool, reshape, concat, split,
        # slice, mean, mv, scans, ...): gather every sharded operand and
        # compute replicated.  Correct for any op; the cost model decides
        # whether the strategy is still worth it.
        for i in spec.ins:
            st.gather(i, task.name)
        for o in spec.outs:
            st.dims[o] = [None] * len(st.graph.buffers[o].shape)


def propagate(graph, mesh: MeshSpec, strategy: str):
    """Run the placement rules; return (specs, raw collective events)."""
    st = _Prop(graph, mesh)
    dp = strategy in ("dp", "dp_tp")
    tp_axis = _tp_axis(mesh) if strategy in ("tp", "dp_tp") else None
    if strategy in ("tp", "dp_tp") and tp_axis is None:
        raise PartitionError(
            f"strategy {strategy!r} needs a tensor axis; mesh has only "
            f"{mesh.names}")
    if dp:
        ax = _dp_axis(mesh)
        for buf in graph.inputs():
            if len(buf.shape) >= 1 and st.divides(buf.name, 0, ax):
                st.spec(buf.name)[0] = ax
    for task in graph.toposort():
        if task.spec is None:
            raise PartitionError(f"task {task.name} has no op spec")
        _visit(st, task, tp_axis)
    specs = {name: ShardSpec(tuple(st.spec(name)))
             for name in graph.buffers}
    return specs, st.events


def _candidates(mesh: MeshSpec) -> list[str]:
    cands = ["replicate", "dp"]
    if _tp_axis(mesh) is not None:
        cands += ["tp", "dp_tp"]
    return cands


def partition(compiled, mesh, strategy: str = "auto",
              hw: HwParams = V5E) -> ShardingPlan:
    """Partition a compiled design (or bare graph) across ``mesh``.

    ``compiled`` is a ``CompiledDataflow`` (its buffer/transfer plans size
    the collective buffers) or a ``DataflowGraph``.  ``mesh`` is a
    :class:`~repro_torch.launch.mesh.Mesh` or a :class:`MeshSpec`.
    ``strategy="auto"`` prices every feasible candidate with
    :func:`estimate_sharding` and keeps the cheapest; the explicit names
    force one.
    """
    spec = MeshSpec.of(mesh)
    graph = getattr(compiled, "graph", compiled)
    buffer_plan = getattr(compiled, "buffer_plan", None)
    transfer_plan = getattr(compiled, "transfer_plan", None)
    if strategy not in STRATEGIES:
        raise PartitionError(
            f"unknown strategy {strategy!r}; pick one of {STRATEGIES}")

    def build(name: str) -> ShardingPlan:
        specs, events = propagate(graph, spec, name)
        steps = _coll.build_steps(graph, spec, events,
                                  buffer_plan=buffer_plan,
                                  transfer_plan=transfer_plan)
        plan = ShardingPlan(mesh=spec, strategy=name, specs=specs,
                            steps=steps)
        est = estimate_sharding(graph, plan, hw)
        return ShardingPlan(mesh=spec, strategy=name, specs=specs,
                            steps=steps, estimated_cycles=est.total_cycles)

    if strategy != "auto":
        return build(strategy)
    plans = [build(name) for name in _candidates(spec)]
    return min(plans, key=lambda p: p.estimated_cycles)
