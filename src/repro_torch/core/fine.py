"""Fine-grained dataflow-violation elimination (paper §IV-B, Figs. 5-6).

Two transformations make producer/consumer streams FIFO-compatible:

1. **Reduction operation rewriting** (Fig. 5) — when a write (or read)
   sits inside loops that do not appear in its index ("reduction dims"),
   the element is touched once per reduction iteration: an access-count
   mismatch that deadlocks a FIFO.  The rewrite (a) moves reduction dims
   innermost, (b) accumulates into a temporary, and (c) emits the FIFO
   access exactly once per element *as early as possible* — in IR terms the
   access's ``enclosing`` set shrinks to its index dims.  On TPU this is
   precisely the VMEM-scratch accumulator of a blocked matmul / online
   softmax: the k-loop accumulates in registers/VMEM and the tile is
   emitted once.

2. **Permutation map generation** (Fig. 6) — when producer and consumer
   stream the same elements in different orders, the *reference* loop (the
   compute-bottleneck task) keeps its order and the *target* loop is
   permuted to match, via a dim→depth map on both sides (Steps 1-4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import DataflowGraph, Task
from .patterns import (BROADCAST_REREAD, MULTI_WRITE, ORDER_MISMATCH,
                       access_sig, arrival_order, fine_violations,
                       index_dims, reduction_dims)

_MAX_ITERS = 200

# Pipeline declaration consumed by passes.default_passes().
PASS_INFO = {
    "name": "fine",
    "result_attr": "fine_report",
    "option_flag": "fine",
    "invalidates": (),
    "description": "fine-grained violation elimination (Figs. 5-6)",
}


@dataclass
class PermutationMap:
    """Fig. 6's depth→depth map, recorded for the report/tests."""

    target: str
    reference: str
    buffer: str
    depth_map: dict[int, int]


@dataclass
class FineReport:
    reductions_rewritten: list[str] = field(default_factory=list)
    permutations: list[PermutationMap] = field(default_factory=list)
    unresolved: list[str] = field(default_factory=list)
    iterations: int = 0

    def merge(self, other: "FineReport") -> "FineReport":
        """Fold a re-run's report into this one.  A re-run happens when a
        later pass (reuse) invalidates fine's guarantees; the re-run's
        ``unresolved`` list is the authoritative final state."""
        self.reductions_rewritten += other.reductions_rewritten
        self.permutations += other.permutations
        self.unresolved = other.unresolved
        self.iterations += other.iterations
        return self

    def summary(self) -> str:
        return (f"fine: {len(self.reductions_rewritten)} reductions rewritten, "
                f"{len(self.permutations)} loops permuted, "
                f"{len(self.unresolved)} unresolved ({self.iterations} iters)")


# --------------------------------------------------------------------------
# 1) Reduction operation rewriting (Fig. 5)
# --------------------------------------------------------------------------


def rewrite_reduction_write(task: Task, buffer: str) -> bool:
    """Hoist the write to ``buffer`` out of its reduction dims."""
    w = task.writes_to(buffer)[0]
    red = reduction_dims(task, w)
    if not red:
        return False
    idx = set(index_dims(task, w))
    red_set = set(red)
    # (a) index dims keep relative order and move outward; reduction dims
    #     move innermost (the shaded region of Fig. 5).
    task.loops = ([l for l in task.loops if l.var in idx]
                  + [l for l in task.loops if l.var not in idx and l.var not in red_set]
                  + [l for l in task.loops if l.var in red_set])
    for l in task.loops:
        if l.var in red_set:
            l.ring = "reduction"
    # (b)+(c): accumulate into a temp, emit once per element, just-in-time.
    w.enclosing = tuple(index_dims(task, w))
    task.reuse_buffers.setdefault(f"acc_{buffer}", (1,))
    task.reduction_rewritten = True
    task.tags.add("reduction-rewritten")
    return True


def rewrite_reduction_read(task: Task, buffer: str) -> bool:
    """Dual of the write rewrite: a consumer that re-reads each element
    across reduction dims is rewritten to read once into a temporary and
    reuse it (the Fig. 5 consumer side / broadcast-operand caching)."""
    r = task.reads_from(buffer)[0]
    red = reduction_dims(task, r)
    if not red:
        return False
    r.enclosing = tuple(index_dims(task, r))
    task.reuse_buffers.setdefault(f"cache_{buffer}", (1,))
    task.tags.add("read-cached")
    return True


# --------------------------------------------------------------------------
# 2) Permutation map generation (Fig. 6)
# --------------------------------------------------------------------------


def _intensity(task: Task) -> float:
    """Reference-loop selection metric: trip counts × computational
    intensity (§IV-B-2)."""
    return task.flops + 0.001 * task.total_iters


def _driver_var(task: Task, dim) -> str | None:
    trips = {l.var: l.trip for l in task.loops}
    live = [v for (v, _s) in dim if trips.get(v, 1) > 1]
    if not live:
        return None
    return min(live, key=lambda v: task.loop_depth(v))


def generate_permutation(graph: DataflowGraph, reference: Task, target: Task,
                         buffer: str) -> PermutationMap | None:
    """Permute ``target``'s loop nest so its access order on ``buffer``
    matches ``reference``'s (Fig. 6 Steps 1-4)."""
    ref_acc = (reference.writes_to(buffer) or reference.reads_from(buffer))[0]
    tgt_acc = (target.writes_to(buffer) or target.reads_from(buffer))[0]

    # Step 1: dim -> loop-depth maps on both sides.
    ref_order = arrival_order(reference, ref_acc)      # array dims, arrival order
    tgt_drivers = {}
    for i, dim in enumerate(tgt_acc.index):
        v = _driver_var(target, dim)
        if v is not None:
            tgt_drivers[i] = v
    # Step 2 (tiling size 1 to align depth sets) is an identity on trip
    # counts; the depth alignment falls out of re-sorting below.
    desired = [tgt_drivers[i] for i in ref_order if i in tgt_drivers]
    if len(set(desired)) != len(desired):
        return None  # one var drives two dims: not a pure permutation
    red = {l.var for l in target.loops if l.ring == "reduction"}
    if red & set(desired):
        # A rewritten reduction (Fig. 5) keeps its reduction dims innermost
        # — the hoisted write emits each element once after the accumulator
        # drains.  Hoisting such a loop outward to chase a neighbour's
        # stream order would silently undo that rewrite (backward graphs
        # hit this: weight-grad matmuls contract over the sequence dim and
        # ask their operands for a genuinely reversed order).  Decline; the
        # edge stays ping-pong.
        return None

    # Step 3: depth→depth map.
    old_depths = {v: target.loop_depth(v) for v in desired}
    depth_map = {old_depths[v]: k for k, v in enumerate(desired)}

    # Step 4: permute the nest — desired vars first in arrival order, the
    # remaining loops (reduction dims etc.) keep relative order after them.
    head = [target.loop(v) for v in desired]
    tail = [l for l in target.loops if l.var not in set(desired)]
    target.loops = head + tail
    target.tags.add("permuted")
    return PermutationMap(target.name, reference.name, buffer, depth_map)


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def eliminate_fine(graph: DataflowGraph) -> FineReport:
    """Fixpoint: rewrite reductions first (count repair), then permute loop
    orders toward the bottleneck reference (order repair).  Violations that
    survive (STENCIL_REREAD before reuse generation, genuine count
    mismatches) are left for buffers.py to downgrade to ping-pong."""
    report = FineReport()
    for it in range(_MAX_ITERS):
        report.iterations = it
        vs = fine_violations(graph)
        if not vs:
            break
        progressed = False
        for v in vs:
            if v.kind == MULTI_WRITE:
                t = graph.task(v.producer)
                if rewrite_reduction_write(t, v.buffer):
                    report.reductions_rewritten.append(f"{t.name}:{v.buffer}")
                    progressed = True
                    break
            elif v.kind == BROADCAST_REREAD:
                t = graph.task(v.consumer)
                if rewrite_reduction_read(t, v.buffer):
                    report.reductions_rewritten.append(f"{t.name}:{v.buffer}(read)")
                    progressed = True
                    break
            elif v.kind == ORDER_MISMATCH:
                p, c = graph.task(v.producer), graph.task(v.consumer)
                if "permuted" in p.tags and "permuted" in c.tags:
                    continue  # both already aligned to references; unresolvable here
                ref, tgt = (p, c) if _intensity(p) >= _intensity(c) else (c, p)
                if "permuted" in tgt.tags or "reuse-rewritten" in tgt.tags:
                    ref, tgt = tgt, ref   # never un-permute an aligned task
                if "permuted" in tgt.tags or "reuse-rewritten" in tgt.tags:
                    continue
                pm = generate_permutation(graph, ref, tgt, v.buffer)
                if pm is not None:
                    report.permutations.append(pm)
                    progressed = True
                    break
        if not progressed:
            break
    report.unresolved = [f"{v.kind}:{v.buffer}({v.producer}->{v.consumer})"
                         for v in fine_violations(graph)]
    return report
