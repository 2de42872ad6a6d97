"""Dataflow-graph IR for the CODO compiler (paper §III/IV).

A :class:`DataflowGraph` is a DAG of :class:`Task` nodes connected through
named :class:`Buffer` objects.  Each task carries an *affine loop-nest
signature* — an ordered loop list plus array accesses whose index
expressions are (coefficient, loop-var) affine sums, which is exactly the
class CODO targets: "affine programs with constant loop bounds" (§VII-A).

The IR is deliberately *schedule-carrying*: passes mutate loop order,
access enclosing-sets, parallel degrees and buffer implementations in place
of the C++ source rewrites the paper performs on MLIR.  Numeric semantics
live separately in ``Task.spec`` — a declarative, picklable
:class:`~repro_torch.core.ops.OpSpec` record from which ``Task.fn`` (the pure-jnp
implementation of the whole op) is derived on demand — so every pass is
semantics-preserving by construction and correctness is checked by
executing the lowered program against the un-optimized oracle.  Raw
closures are still accepted (``Task(..., fn=lambda env: ...)``) for ad-hoc
graphs, but they cannot cross pickle boundaries (disk cache, process
pools); see ``repro/core/ops.py`` for the registry contract.

Two IR features carry the paper's fine-grained machinery:

* ``Access.enclosing`` — the set of loops that dynamically enclose the
  access.  Fig. 5's reduction rewriting hoists a FIFO write *out* of the
  reduction loops: here that is ``write.enclosing = index_dims``.  Fig. 7's
  post-reuse code has *sibling* loop regions (a load region and a compute
  region inside one task); ``enclosing`` expresses "this access runs under
  loops {n,h,w,ci} only" even when the task's nest also has ``co``.
* stride-carrying index expressions — ``input[(h,1),(kh,1)]`` models
  ``input[h+kh]`` (a conv window), ``input[(oh,2),(kh,1)]`` models a
  stride-2 pooling window.  Spans/overlap are computed from these.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from .ops import OpSpec, materialize

# --------------------------------------------------------------------------
# Loops and accesses
# --------------------------------------------------------------------------


@dataclass
class Loop:
    """One loop of a task's nest.  ``var`` names are unique per task."""

    var: str
    trip: int
    # scheduling state (written by core.schedule / core.reuse)
    parallel: int = 1          # unroll / vector-lane degree
    tile: int = 0              # tile size from inter-task propagation (0 = untiled)
    ring: str = "free"         # reuse.py classification: outer|fifo|reduction|free

    def copy(self) -> "Loop":
        return dataclasses.replace(self)


# One array-dim index expression: affine sum of (var, stride) terms.
# () is a constant dim;  (("h",1),("kh",1)) is input[h+kh].
IndexExpr = tuple[tuple[str, int], ...]


def idx(*terms) -> IndexExpr:
    """idx("h") -> (("h",1),);  idx(("oh",2),"kh") -> (("oh",2),("kh",1))."""
    out = []
    for t in terms:
        if isinstance(t, str):
            out.append((t, 1))
        else:
            out.append((t[0], int(t[1])))
    return tuple(out)


@dataclass
class Access:
    """A read or write of ``buffer`` inside a task's loop nest."""

    buffer: str
    index: tuple[IndexExpr, ...]
    is_write: bool
    # Loop vars that dynamically enclose this access.  None = all of the
    # task's loops.  Set by fine-grained rewriting / reuse generation.
    enclosing: tuple[str, ...] | None = None
    # Logical per-dim stream extent override.  After reuse rewriting, the
    # load region consumes the *input* extent (e.g. the padded 34×34 rows)
    # exactly once even though the compute loops span the output extent;
    # Fig. 7's sibling-region structure.  None = derive from index/trips.
    stream_shape: tuple[int, ...] | None = None

    def vars(self) -> set[str]:
        return {v for dim in self.index for (v, _s) in dim}

    def copy(self) -> "Access":
        return dataclasses.replace(
            self,
            index=tuple(tuple(term for term in dim) for dim in self.index),
            enclosing=None if self.enclosing is None else tuple(self.enclosing),
            stream_shape=None if self.stream_shape is None else tuple(self.stream_shape),
        )


# --------------------------------------------------------------------------
# Buffers
# --------------------------------------------------------------------------

# Buffer communication implementations (paper §V-A).
FIFO = "fifo"          # streaming, element granularity  -> TPU: fused through VMEM
PINGPONG = "pingpong"  # double-buffered block           -> TPU: HBM materialization
UNDECIDED = "undecided"


@dataclass
class Buffer:
    name: str
    shape: tuple[int, ...]
    dtype: Any = np.float32
    kind: str = "intermediate"  # input | weight | intermediate | output
    impl: str = UNDECIDED       # FIFO / PINGPONG, set by buffers.py
    fifo_depth: int = 0         # elements, set when impl == FIFO
    hbm_channel: int = -1       # set by offchip.py for off-chip buffers
    burst_len: int = 0          # elements per burst, set by offchip.py

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * np.dtype(self.dtype).itemsize

    def copy(self) -> "Buffer":
        return dataclasses.replace(self)


# --------------------------------------------------------------------------
# Tasks
# --------------------------------------------------------------------------


@dataclass
class Task:
    """A computational node: one loop nest with reads/writes.

    Numeric semantics: ``fn(env) -> {buf: array}`` (``env`` maps buffer
    names to arrays) is a *derived property*.  The durable representation
    is ``spec`` — a declarative :class:`~repro_torch.core.ops.OpSpec` the op
    registry materializes into a jnp callable on demand — which survives
    pickling (disk compile cache, process-pool batch compiles).  A raw
    closure passed as ``fn=`` takes precedence but is stripped at every
    pickle boundary.  Passes never change numeric semantics — they change
    the *schedule metadata* that the cost model and lowering consume (when
    an access is retargeted to a duplicated buffer, :meth:`retarget`
    renames the spec's operands — pure data — or wraps a closure with an
    env-aliasing shim, see coarse.py).
    """

    name: str
    loops: list[Loop]
    reads: list[Access]
    writes: list[Access]
    op: str = "generic"            # conv | matmul | ewise | pad | pool | norm | softmax ...
    flops_per_iter: float = 1.0
    bytes_per_iter: float = 0.0    # extra non-edge traffic per innermost iteration
    fn: Callable[[dict], dict] | None = None   # closure override (see property below)
    spec: OpSpec | None = None     # declarative numeric semantics (picklable)
    # --- schedule state -----------------------------------------------------
    fused_group: int = -1          # fusion-group id assigned by lowering
    stage: int = -1                # pipeline stage (pipeline.py)
    reduction_rewritten: bool = False
    reuse_buffers: dict = field(default_factory=dict)  # name -> shape tuple (reuse.py)
    tags: set = field(default_factory=set)

    # --- loop helpers ---------------------------------------------------------
    def loop(self, var: str) -> Loop:
        for l in self.loops:
            if l.var == var:
                return l
        raise KeyError(f"{self.name}: no loop {var!r}")

    def has_loop(self, var: str) -> bool:
        return any(l.var == var for l in self.loops)

    def loop_depth(self, var: str) -> int:
        for i, l in enumerate(self.loops):
            if l.var == var:
                return i
        raise KeyError(f"{self.name}: no loop {var!r}")

    def trip_product(self, vars_: Sequence[str] | None = None) -> int:
        if vars_ is None:
            loops = self.loops
        else:
            vs = set(vars_)
            loops = [l for l in self.loops if l.var in vs]
        return int(np.prod([l.trip for l in loops])) if loops else 1

    @property
    def total_iters(self) -> int:
        return self.trip_product()

    @property
    def flops(self) -> float:
        return self.flops_per_iter * self.total_iters

    # --- access helpers -------------------------------------------------------
    def accesses(self, buffer: str | None = None) -> list[Access]:
        acc = self.reads + self.writes
        if buffer is not None:
            acc = [a for a in acc if a.buffer == buffer]
        return acc

    def writes_to(self, buffer: str) -> list[Access]:
        return [a for a in self.writes if a.buffer == buffer]

    def reads_from(self, buffer: str) -> list[Access]:
        return [a for a in self.reads if a.buffer == buffer]

    def enclosing_vars(self, a: Access) -> list[str]:
        """Loop vars enclosing access ``a``, in loop-nest order."""
        if a.enclosing is None:
            return [l.var for l in self.loops]
        enc = set(a.enclosing)
        return [l.var for l in self.loops if l.var in enc]

    # --- numeric semantics ----------------------------------------------------
    @property
    def fn_is_closure(self) -> bool:
        """True when a raw closure override is attached (not picklable)."""
        return self._fn is not None

    def retarget(self, alias: dict[str, str]) -> None:
        """Rename the numeric semantics' buffer operands (old -> new).

        With a declarative spec this is a pure data rename; a closure
        override is wrapped with the :func:`retarget_fn` env-aliasing shim.
        """
        if self.spec is not None:
            self.spec = self.spec.renamed(alias)
        if self._fn is not None:
            self._fn = retarget_fn(self._fn, alias)

    def copy(self) -> "Task":
        return dataclasses.replace(
            self,
            loops=[l.copy() for l in self.loops],
            reads=[a.copy() for a in self.reads],
            writes=[a.copy() for a in self.writes],
            fn=self._fn,
            spec=self.spec.copy() if self.spec is not None else None,
            reuse_buffers=dict(self.reuse_buffers),
            tags=set(self.tags),
        )


def _task_fn_get(self: Task) -> Callable[[dict], dict] | None:
    """``Task.fn``: the closure override if set, else the registry
    materialization of ``spec``, else None."""
    if self._fn is not None:
        return self._fn
    if self.spec is not None:
        return materialize(self.spec)
    return None


def _task_fn_set(self: Task, value: Callable[[dict], dict] | None) -> None:
    self._fn = value


# ``fn`` is a derived property: the dataclass-generated __init__ still
# accepts ``fn=`` (its assignment routes through the setter into ``_fn``),
# so closure-based construction keeps working, while spec-carrying tasks
# re-derive their callable after any pickle round-trip.
Task.fn = property(_task_fn_get, _task_fn_set)


# --------------------------------------------------------------------------
# JSON views (docs/artifact_format.md).  Index expressions serialize as
# [[var, stride], ...] per array dim; None distinguishes "unset" from an
# empty tuple for ``enclosing``/``stream_shape``.
# --------------------------------------------------------------------------


def _index_to_json(index: tuple[IndexExpr, ...]) -> list:
    return [[[v, s] for (v, s) in dim] for dim in index]


def _index_from_json(doc) -> tuple[IndexExpr, ...]:
    return tuple(tuple((str(v), int(s)) for (v, s) in dim) for dim in doc)


def _access_to_dict(a: Access) -> dict:
    return {
        "buffer": a.buffer,
        "index": _index_to_json(a.index),
        "is_write": a.is_write,
        "enclosing": None if a.enclosing is None else list(a.enclosing),
        "stream_shape": None if a.stream_shape is None else list(a.stream_shape),
    }


def _access_from_dict(doc: dict) -> Access:
    enc = doc.get("enclosing")
    ss = doc.get("stream_shape")
    return Access(
        buffer=doc["buffer"],
        index=_index_from_json(doc["index"]),
        is_write=bool(doc["is_write"]),
        enclosing=None if enc is None else tuple(str(v) for v in enc),
        stream_shape=None if ss is None else tuple(int(s) for s in ss),
    )


def _buffer_to_dict(b: Buffer) -> dict:
    return {
        "name": b.name, "shape": list(b.shape),
        "dtype": np.dtype(b.dtype).name, "kind": b.kind, "impl": b.impl,
        "fifo_depth": b.fifo_depth, "hbm_channel": b.hbm_channel,
        "burst_len": b.burst_len,
    }


def _buffer_from_dict(doc: dict) -> Buffer:
    return Buffer(
        name=doc["name"], shape=tuple(int(s) for s in doc["shape"]),
        dtype=np.dtype(doc.get("dtype", "float32")),
        kind=doc.get("kind", "intermediate"),
        impl=doc.get("impl", UNDECIDED),
        fifo_depth=int(doc.get("fifo_depth", 0)),
        hbm_channel=int(doc.get("hbm_channel", -1)),
        burst_len=int(doc.get("burst_len", 0)),
    )


def _task_to_dict(t: Task) -> dict:
    return {
        "name": t.name,
        "loops": [{"var": l.var, "trip": l.trip, "parallel": l.parallel,
                   "tile": l.tile, "ring": l.ring} for l in t.loops],
        "reads": [_access_to_dict(a) for a in t.reads],
        "writes": [_access_to_dict(a) for a in t.writes],
        "op": t.op,
        "flops_per_iter": t.flops_per_iter,
        "bytes_per_iter": t.bytes_per_iter,
        "fused_group": t.fused_group,
        "stage": t.stage,
        "reduction_rewritten": t.reduction_rewritten,
        "reuse_buffers": {k: list(v) for k, v in t.reuse_buffers.items()},
        "tags": sorted(t.tags),
        "spec": t.spec.to_dict() if t.spec is not None else None,
    }


def _task_from_dict(doc: dict) -> Task:
    spec = doc.get("spec")
    return Task(
        name=doc["name"],
        loops=[Loop(l["var"], int(l["trip"]), int(l.get("parallel", 1)),
                    int(l.get("tile", 0)), l.get("ring", "free"))
               for l in doc["loops"]],
        reads=[_access_from_dict(a) for a in doc.get("reads", ())],
        writes=[_access_from_dict(a) for a in doc.get("writes", ())],
        op=doc.get("op", "generic"),
        flops_per_iter=float(doc.get("flops_per_iter", 1.0)),
        bytes_per_iter=float(doc.get("bytes_per_iter", 0.0)),
        spec=None if spec is None else OpSpec.from_dict(spec),
        fused_group=int(doc.get("fused_group", -1)),
        stage=int(doc.get("stage", -1)),
        reduction_rewritten=bool(doc.get("reduction_rewritten", False)),
        reuse_buffers={k: tuple(int(s) for s in v)
                       for k, v in doc.get("reuse_buffers", {}).items()},
        tags=set(doc.get("tags", ())),
    )


def retarget_fn(fn: Callable[[dict], dict], alias: dict[str, str]) -> Callable[[dict], dict]:
    """Wrap a task fn so that buffer renames stay numerically transparent.

    ``alias`` maps *old* buffer name -> *new* buffer name.  Reads of the old
    name look up the new one; writes of the old name are emitted under the
    new one.
    """

    def wrapped(env: dict) -> dict:
        shadow = dict(env)
        for old, new in alias.items():
            if new in env:
                shadow[old] = env[new]
        out = fn(shadow)
        renamed = {}
        for k, v in out.items():
            renamed[alias.get(k, k)] = v
        return renamed

    return wrapped


# --------------------------------------------------------------------------
# Graph
# --------------------------------------------------------------------------


class GraphError(RuntimeError):
    pass


class DataflowGraph:
    """Topologically-ordered task DAG + buffer table."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.tasks: list[Task] = []
        self.buffers: dict[str, Buffer] = {}

    # --- construction -----------------------------------------------------
    def add_buffer(self, buf: Buffer) -> Buffer:
        if buf.name in self.buffers:
            raise GraphError(f"duplicate buffer {buf.name!r}")
        self.buffers[buf.name] = buf
        return buf

    def buffer(
        self, name: str, shape: Sequence[int], dtype=np.float32, kind: str = "intermediate"
    ) -> Buffer:
        return self.add_buffer(Buffer(name, tuple(int(s) for s in shape), dtype, kind))

    def add_task(self, task: Task) -> Task:
        for a in task.accesses():
            if a.buffer not in self.buffers:
                raise GraphError(f"{task.name}: unknown buffer {a.buffer!r}")
        if any(t.name == task.name for t in self.tasks):
            raise GraphError(f"duplicate task {task.name!r}")
        self.tasks.append(task)
        return task

    def remove_task(self, name: str) -> None:
        self.tasks = [t for t in self.tasks if t.name != name]

    # --- topology -----------------------------------------------------------
    def producers(self, buffer: str) -> list[Task]:
        return [t for t in self.tasks if t.writes_to(buffer)]

    def consumers(self, buffer: str) -> list[Task]:
        return [t for t in self.tasks if t.reads_from(buffer)]

    def task(self, name: str) -> Task:
        for t in self.tasks:
            if t.name == name:
                return t
        raise KeyError(name)

    def edges(self) -> list[tuple[Task, str, Task]]:
        """(producer, buffer, consumer) triples."""
        out = []
        for buf in self.buffers.values():
            for p in self.producers(buf.name):
                for c in self.consumers(buf.name):
                    out.append((p, buf.name, c))
        return out

    def internal_edges(self) -> list[tuple[Task, str, Task]]:
        return [(p, b, c) for (p, b, c) in self.edges()
                if self.buffers[b].kind not in ("input", "weight")]

    def inputs(self) -> list[Buffer]:
        return [b for b in self.buffers.values() if b.kind == "input"]

    def weights(self) -> list[Buffer]:
        return [b for b in self.buffers.values() if b.kind == "weight"]

    def outputs(self) -> list[Buffer]:
        return [b for b in self.buffers.values() if b.kind == "output"]

    def intermediates(self) -> list[Buffer]:
        return [b for b in self.buffers.values() if b.kind == "intermediate"]

    # --- validation -----------------------------------------------------------
    def toposort(self) -> list[Task]:
        """Topological order by buffer dependencies; raises on cycles."""
        prod_of: dict[str, list[str]] = {}
        for t in self.tasks:
            for a in t.writes:
                prod_of.setdefault(a.buffer, []).append(t.name)
        indeg = {t.name: 0 for t in self.tasks}
        succ: dict[str, list[str]] = {t.name: [] for t in self.tasks}
        for t in self.tasks:
            for a in t.reads:
                for p in prod_of.get(a.buffer, []):
                    if p != t.name:
                        succ[p].append(t.name)
                        indeg[t.name] += 1
        order, queue = [], sorted([t.name for t in self.tasks if indeg[t.name] == 0],
                                  key=lambda n: [t.name for t in self.tasks].index(n))
        while queue:
            n = queue.pop(0)
            order.append(n)
            for s in succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    queue.append(s)
        if len(order) != len(self.tasks):
            raise GraphError(f"{self.name}: cycle detected in dataflow graph")
        by_name = {t.name: t for t in self.tasks}
        return [by_name[n] for n in order]

    def validate(self) -> None:
        self.toposort()
        for t in self.tasks:
            vars_ = {l.var for l in t.loops}
            if len(vars_) != len(t.loops):
                raise GraphError(f"{t.name}: duplicate loop vars")
            for a in t.accesses():
                missing = a.vars() - vars_
                if missing:
                    raise GraphError(f"{t.name}: access {a.buffer} uses unknown vars {missing}")
                buf = self.buffers[a.buffer]
                if len(a.index) != len(buf.shape):
                    raise GraphError(
                        f"{t.name}: access rank {len(a.index)} != buffer {a.buffer} rank"
                        f" {len(buf.shape)}"
                    )
                if a.enclosing is not None:
                    bad = set(a.enclosing) - vars_
                    if bad:
                        raise GraphError(f"{t.name}: enclosing uses unknown vars {bad}")

    def copy(self) -> "DataflowGraph":
        g = DataflowGraph(self.name)
        g.buffers = {k: v.copy() for k, v in self.buffers.items()}
        g.tasks = [t.copy() for t in self.tasks]
        return g

    # --- JSON serialization ---------------------------------------------------
    # The graph side of the portable-artifact format: a language-neutral
    # dict covering everything ``structural_signature()`` covers (so a
    # round-trip preserves the structural hash) *except* closure ``fn``
    # overrides, which cannot serialize — spec-carrying graphs round-trip
    # executable.  Versioning/validation live in ``repro_torch.core.artifact``;
    # the field-by-field contract is docs/artifact_format.md.
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "buffers": [_buffer_to_dict(b) for b in self.buffers.values()],
            "tasks": [_task_to_dict(t) for t in self.tasks],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "DataflowGraph":
        g = cls(doc["name"])
        for b in doc.get("buffers", ()):
            g.add_buffer(_buffer_from_dict(b))
        for t in doc.get("tasks", ()):
            g.add_task(_task_from_dict(t))
        g.validate()
        return g

    # --- content addressing ---------------------------------------------------
    def structural_signature(self) -> tuple:
        """Canonical nested-tuple view of everything the compiler's passes
        read: loop nests, accesses, buffer table, schedule state — plus each
        task's declarative ``spec`` (kind, operands, attrs).  Closure
        ``fn`` overrides are deliberately excluded — closures don't affect
        any pass decision, and two builds of the same model produce equal
        signatures even though their lambdas differ.

        Spec-carrying tasks are fully covered: semantic constants live in
        ``OpSpec.attrs``, which enters the signature, so graphs differing
        only in (say) a scale factor never collide in the compile cache.
        Contract for closure-based builders: any semantic constant that
        lives *only* in a closure must also appear in the structure —
        conventionally a ``const:...`` entry in ``Task.tags``."""

        def acc_sig(a: Access) -> tuple:
            return (a.buffer, a.index, a.is_write, a.enclosing, a.stream_shape)

        bufs = tuple(sorted(
            (b.name, b.shape, np.dtype(b.dtype).str, b.kind, b.impl,
             b.fifo_depth, b.hbm_channel, b.burst_len)
            for b in self.buffers.values()))
        tasks = tuple(
            (t.name,
             tuple((l.var, l.trip, l.parallel, l.tile, l.ring) for l in t.loops),
             tuple(acc_sig(a) for a in t.reads),
             tuple(acc_sig(a) for a in t.writes),
             t.op, float(t.flops_per_iter), float(t.bytes_per_iter),
             t.fused_group, t.stage, t.reduction_rewritten,
             tuple(sorted((k, tuple(v)) for k, v in t.reuse_buffers.items())),
             tuple(sorted(t.tags)),
             t.spec.signature() if t.spec is not None else None)
            for t in self.tasks)
        return (self.name, bufs, tasks)

    def structural_hash(self) -> str:
        """Stable content hash (hex) of :meth:`structural_signature` —
        identical across processes (sha256, not the salted builtin hash), so
        it can key an on-disk compile cache."""
        import hashlib
        payload = repr(self.structural_signature()).encode()
        return hashlib.sha256(payload).hexdigest()

    # --- execution (oracle path) ----------------------------------------------
    def execute(self, env: dict[str, Any]) -> dict[str, Any]:
        """Run every task's ``fn`` in topo order.  Pure; used as the oracle
        and as the body the lowering jit-compiles."""
        env = dict(env)
        for t in self.toposort():
            fn = t.fn
            if fn is None:
                raise GraphError(
                    f"{t.name}: no numeric semantics attached (neither a "
                    f"declarative spec nor a closure fn)")
            out = fn(env)
            env.update(out)
        return {b.name: env[b.name] for b in self.outputs()}

    def summary(self) -> str:
        lines = [f"graph {self.name}: {len(self.tasks)} tasks, {len(self.buffers)} buffers"]
        for t in self.tasks:
            nest = " ".join(f"{l.var}:{l.trip}" + (f"*{l.parallel}" if l.parallel > 1 else "")
                            for l in t.loops)
            rs = ",".join(sorted({a.buffer for a in t.reads}))
            ws = ",".join(sorted({a.buffer for a in t.writes}))
            lines.append(f"  {t.name:<28s} [{t.op:<8s}] ({nest}) {rs} -> {ws}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Task constructors — the vocabulary model builders use.
# --------------------------------------------------------------------------

_uid = itertools.count()


def _fresh(prefix: str) -> str:
    return f"{prefix}_{next(_uid)}"


def full_index(dims: Sequence[str]) -> tuple[IndexExpr, ...]:
    return tuple(idx(d) for d in dims)


def ewise_task(
    name: str,
    out: str,
    ins: Sequence[str],
    shape: Sequence[int],
    fn: Callable[[dict], dict] | None = None,
    op: str = "ewise",
    flops_per_iter: float = 1.0,
    dim_names: Sequence[str] | None = None,
    spec: OpSpec | None = None,
) -> Task:
    dims = list(dim_names) if dim_names else [f"i{k}" for k in range(len(shape))]
    loops = [Loop(d, int(s)) for d, s in zip(dims, shape)]
    reads = [Access(b, full_index(dims), False) for b in ins]
    writes = [Access(out, full_index(dims), True)]
    return Task(name, loops, reads, writes, op=op, flops_per_iter=flops_per_iter,
                fn=fn, spec=spec)


def matmul_task(
    name: str,
    out: str,
    lhs: str,
    rhs: str,
    m: int,
    n: int,
    k: int,
    fn: Callable[[dict], dict] | None = None,
    batch: int = 0,
    spec: OpSpec | None = None,
) -> Task:
    """out[m,n] += lhs[m,k] * rhs[k,n]; the write sits inside the k
    reduction — the canonical access-count-mismatch producer Fig. 5
    rewrites — and the lhs read repeats across n — the broadcast re-read
    the reuse pass caches."""
    loops, out_idx, l_idx, r_idx = [], [], [], []
    if batch:
        loops.append(Loop("b", batch))
        out_idx.append(idx("b")); l_idx.append(idx("b")); r_idx.append(idx("b"))
    loops += [Loop("m", m), Loop("n", n), Loop("k", k)]
    out_idx += [idx("m"), idx("n")]
    l_idx += [idx("m"), idx("k")]
    r_idx += [idx("k"), idx("n")]
    reads = [Access(lhs, tuple(l_idx), False), Access(rhs, tuple(r_idx), False)]
    writes = [Access(out, tuple(out_idx), True)]  # enclosed by k: violation
    return Task(name, loops, reads, writes, op="matmul", flops_per_iter=2.0,
                fn=fn, spec=spec)


def conv2d_task(
    name: str,
    out: str,
    inp: str,
    weight: str,
    n: int,
    co: int,
    ci: int,
    h: int,
    w: int,
    kh: int,
    kw: int,
    fn: Callable[[dict], dict] | None = None,
    stride: int = 1,
    spec: OpSpec | None = None,
) -> Task:
    """NCHW conv over a pre-padded input of ((h-1)*stride+kh, ...)."""
    loops = [Loop("n", n), Loop("co", co), Loop("h", h), Loop("w", w),
             Loop("ci", ci), Loop("kh", kh), Loop("kw", kw)]
    reads = [
        Access(inp, (idx("n"), idx("ci"), idx(("h", stride), "kh"), idx(("w", stride), "kw")),
               False),
        Access(weight, (idx("co"), idx("ci"), idx("kh"), idx("kw")), False),
    ]
    writes = [Access(out, (idx("n"), idx("co"), idx("h"), idx("w")), True)]
    return Task(name, loops, reads, writes, op="conv", flops_per_iter=2.0,
                fn=fn, spec=spec)


def pad_task(
    name: str,
    out: str,
    inp: str,
    n: int,
    c: int,
    h: int,
    w: int,
    pad: int,
    fn: Callable[[dict], dict] | None = None,
    spec: OpSpec | None = None,
) -> Task:
    """Zero-pad: writes (h+2p, w+2p).  Written in the paper's
    motivating-example loop order (c, h, w) — a deliberate order mismatch
    with the conv consumer which arrives after reuse rewriting."""
    loops = [Loop("n", n), Loop("c", c), Loop("h", h + 2 * pad), Loop("w", w + 2 * pad)]
    reads = [Access(inp, full_index(["n", "c", "h", "w"]), False)]
    writes = [Access(out, full_index(["n", "c", "h", "w"]), True)]
    return Task(name, loops, reads, writes, op="pad", flops_per_iter=0.0,
                fn=fn, spec=spec)


def pool_task(
    name: str,
    out: str,
    inp: str,
    n: int,
    c: int,
    oh: int,
    ow: int,
    k: int,
    fn: Callable[[dict], dict] | None = None,
    op: str = "pool",
    spec: OpSpec | None = None,
) -> Task:
    """k×k pool with stride k: the Fig. 5 reduction producer (write inside
    the window loops) plus a windowed read."""
    loops = [Loop("n", n), Loop("c", c), Loop("oh", oh), Loop("ow", ow),
             Loop("kh", k), Loop("kw", k)]
    reads = [Access(inp, (idx("n"), idx("c"), idx(("oh", k), "kh"), idx(("ow", k), "kw")),
                    False)]
    writes = [Access(out, (idx("n"), idx("c"), idx("oh"), idx("ow")), True)]
    return Task(name, loops, reads, writes, op=op, flops_per_iter=1.0,
                fn=fn, spec=spec)


def reduce_task(
    name: str,
    out: str,
    inp: str,
    keep: Sequence[int],
    shape: Sequence[int],
    fn: Callable[[dict], dict] | None = None,
    op: str = "reduce",
    dim_names: Sequence[str] | None = None,
    spec: OpSpec | None = None,
) -> Task:
    """Generic reduction keeping dims ``keep`` of ``shape``."""
    dims = list(dim_names) if dim_names else [f"r{k}" for k in range(len(shape))]
    loops = [Loop(d, int(s)) for d, s in zip(dims, shape)]
    reads = [Access(inp, full_index(dims), False)]
    out_idx = tuple(idx(dims[i]) for i in keep)
    writes = [Access(out, out_idx, True)]
    return Task(name, loops, reads, writes, op=op, flops_per_iter=1.0,
                fn=fn, spec=spec)


def copy_task(name: str, out: str, inp: str, shape: Sequence[int],
              fn: Callable[[dict], dict] | None = None,
              spec: OpSpec | None = None) -> Task:
    return ewise_task(name, out, [inp], shape, fn=fn, op="copy",
                      flops_per_iter=0.0, spec=spec)
