"""Coarse-grained dataflow-violation elimination (paper §IV-A, Alg. 1, Fig. 4).

HLS dataflow regions (and, equally, fusable streaming kernels on TPU)
require every internal buffer to have exactly one producer and one
consumer.  This pass rewrites the graph until that invariant holds:

* **SPMC** (Fig. 4a, residual/bypass patterns): insert a duplicator node
  ``Node1'`` that reads the buffer once and streams one private copy per
  consumer.
* **MPSC** (Fig. 4b, init/pad pairs): fuse the producers into one node
  (merge semantics — earlier writes are staged and merged into the last
  write), or serialize through a merge node when fusion is illegal.
* **MPMC** (Fig. 4c): fuse/merge the producers first, then the remaining
  SPMC is handled by duplication on the next fixpoint iteration.

All rewrites keep numeric semantics intact declaratively: duplicators are
``OpSpec("dup")`` nodes, fused producers are ``OpSpec("fused")`` composites
of the producers' specs, and consumer rewires are pure-data operand renames
(:meth:`repro_torch.core.graph.Task.retarget`).  Tasks carrying raw closures fall
back to the legacy env-aliasing shims — correct, but such graphs lose
executability at pickle boundaries (disk cache, process pools).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import Access, Buffer, DataflowGraph, Loop, Task, full_index
from .ops import OpSpec
from .patterns import MPMC, MPSC, SPMC, coarse_violations

_MAX_ITERS = 64

# Pipeline declaration consumed by passes.default_passes().
PASS_INFO = {
    "name": "coarse",
    "result_attr": "coarse_report",
    "option_flag": "coarse",
    "invalidates": (),
    "description": "coarse-grained violation elimination (Alg. 1, Fig. 4)",
}


@dataclass
class CoarseReport:
    duplicators_inserted: list[str] = field(default_factory=list)
    fusions: list[str] = field(default_factory=list)
    merges: list[str] = field(default_factory=list)
    iterations: int = 0

    def merge(self, other: "CoarseReport") -> "CoarseReport":
        """Fold a re-run's report into this one (invalidation re-runs)."""
        self.duplicators_inserted += other.duplicators_inserted
        self.fusions += other.fusions
        self.merges += other.merges
        self.iterations += other.iterations
        return self

    def summary(self) -> str:
        return (f"coarse: {len(self.duplicators_inserted)} duplicators, "
                f"{len(self.fusions)} fusions, {len(self.merges)} merges "
                f"({self.iterations} iters)")


# --------------------------------------------------------------------------
# SPMC: duplicator insertion (Fig. 4a)
# --------------------------------------------------------------------------


def _insert_duplicator(graph: DataflowGraph, buffer: str, report: CoarseReport) -> None:
    buf = graph.buffers[buffer]
    consumers = graph.consumers(buffer)
    producers = graph.producers(buffer)

    # Duplicator loop order follows the producer's write arrival order so
    # the producer→duplicator edge is FIFO-clean by construction.
    dims = [f"d{k}" for k in range(len(buf.shape))]
    if producers:
        w = producers[0].writes_to(buffer)[0]
        trips = {l.var: l.trip for l in producers[0].loops}
        order = []
        for i, dim in enumerate(w.index):
            live = [v for (v, _s) in dim if trips.get(v, 1) > 1]
            d = (min(producers[0].loop_depth(v) for v in live)
                 if live else len(producers[0].loops) + i)
            order.append((d, i))
        order.sort()
        loop_dims = [dims[i] for (_d, i) in order]
    else:
        loop_dims = list(dims)
    loops = [Loop(d, int(buf.shape[dims.index(d)])) for d in loop_dims]

    copies = []
    for k, c in enumerate(consumers):
        dup_name = f"{buffer}__dup{k}"
        graph.add_buffer(Buffer(dup_name, buf.shape, buf.dtype, "intermediate"))
        copies.append((c, dup_name))

    node = Task(
        name=f"dup_{buffer}",
        loops=loops,
        reads=[Access(buffer, full_index(dims), False)],
        writes=[Access(d, full_index(dims), True) for (_c, d) in copies],
        op="copy",
        flops_per_iter=0.0,
        spec=OpSpec("dup", (buffer,), tuple(d for (_c, d) in copies)),
    )
    node.tags.add("coarse-duplicator")
    graph.add_task(node)
    report.duplicators_inserted.append(node.name)

    # Rewire each consumer to its private copy (pure data rename).
    for c, dup_name in copies:
        for a in c.reads:
            if a.buffer == buffer:
                a.buffer = dup_name
        c.retarget({buffer: dup_name})


# --------------------------------------------------------------------------
# MPSC: producer fusion / merge (Fig. 4b)
# --------------------------------------------------------------------------


def _outer_domain(task: Task, buffer: str) -> tuple:
    """(trip,...) of the loops indexing the written buffer — the 'outer
    iteration domain' fusion legality test of §IV-A."""
    w = task.writes_to(buffer)[0]
    vars_ = w.vars()
    return tuple(l.trip for l in task.loops if l.var in vars_)


def _has_carried_dep(producers: list[Task], buffer: str) -> bool:
    """A later producer reading the same buffer it writes (accumulation)
    is a loop-carried dependency across the fusion candidates."""
    for t in producers[1:]:
        if t.reads_from(buffer):
            return True
    return False


def _fuse_producers(graph: DataflowGraph, buffer: str, report: CoarseReport) -> None:
    producers = [t for t in graph.toposort() if t.writes_to(buffer)]
    fusable = (
        len({_outer_domain(t, buffer) for t in producers}) == 1
        and not _has_carried_dep(producers, buffer)
    )

    last = producers[-1]
    name = f"fuse_{buffer}"

    # Declarative fusion when every producer is spec-carrying; otherwise a
    # closure composition (which strips at pickle boundaries).
    fused_spec = fused_fn = None
    if all(t.spec is not None and not t.fn_is_closure for t in producers):
        fused_spec = OpSpec("fused", parts=tuple(t.spec for t in producers))
    else:
        fns = tuple(t.fn for t in producers)

        def fused_fn(env, _fns=fns):
            out: dict = {}
            scope = dict(env)
            for f in _fns:
                r = f(scope)
                scope.update(r)
                out.update(r)
            return out

    # Representative loop nest: the last writer's (the merge target).  Reads
    # are the union of all producers' reads minus the fused buffer itself.
    reads, seen = [], set()
    for t in producers:
        for a in t.reads:
            if a.buffer == buffer:
                continue  # staged internally ("temporarily stored ... merged")
            key = (a.buffer, a.index)
            if key not in seen:
                seen.add(key)
                reads.append(a.copy())
    writes, wseen = [], set()
    for t in producers:
        for a in t.writes:
            key = a.buffer
            if key not in wseen:
                wseen.add(key)
                writes.append(a.copy())

    fused = Task(
        name=name,
        loops=[l.copy() for l in last.loops],
        reads=reads,
        writes=writes,
        op=last.op,
        flops_per_iter=sum(t.flops for t in producers) / max(1, last.total_iters),
        fn=fused_fn,
        spec=fused_spec,
    )
    fused.tags.add("coarse-fused")
    if not fusable:
        # Differing inner structure / carried deps: the paper inserts extra
        # control logic; we keep the fused node but flag it so the scheduler
        # treats it as non-parallelizable on the merged dims.
        fused.tags.add("fused-control")
        report.merges.append(name)
    else:
        report.fusions.append(name)

    for t in producers:
        graph.remove_task(t.name)
    graph.add_task(fused)


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def eliminate_coarse(graph: DataflowGraph) -> CoarseReport:
    """Fixpoint application of Alg. 1 over all buffers."""
    report = CoarseReport()
    for it in range(_MAX_ITERS):
        violations = coarse_violations(graph)
        report.iterations = it
        if not violations:
            break
        v = violations[0]
        if v.kind == SPMC:
            _insert_duplicator(graph, v.buffer, report)
        elif v.kind in (MPSC, MPMC):
            _fuse_producers(graph, v.buffer, report)
            # MPMC becomes SPMC after producer fusion; next iteration
            # inserts the duplicator.
        graph.validate()
    else:
        raise RuntimeError(f"coarse elimination did not converge on {graph.name}")
    return report
