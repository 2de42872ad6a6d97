"""Violation-free reuse-buffer generation (paper §V-B, Fig. 7).

Stencil consumers (conv/pool windows) re-read each produced element up to
kh×kw times — incompatible with FIFO streaming.  The paper's fix builds a
**line buffer** (kh-1 retained rows) plus a **window buffer** (the kh×kw
working set) so every input element enters the task exactly once, in the
producer's row-major order, and all re-reads hit on-chip storage.

On TPU the line/window buffers are VMEM scratch inside the fused Pallas
kernel (see kernels/streamfuse); here the pass rewrites the IR so that

* the stencil read collapses to an exact-once read (index dims only,
  ``enclosing`` = the FIFO dims), arriving in (batch, spatial..., ci) order;
* the write's ``enclosing`` set is its own index dims (n, spatial..., co):
  the compute region runs as a sibling region under the spatial loops —
  Fig. 7's three-region structure;
* each loop is classified into the paper's safety rings:
  ``outer`` (red — unsafe to parallelize), ``fifo`` (orange — feasible but
  must be coordinated with the FIFO peer), ``reduction`` (green — free).

That classification is the *guidance for parallelism exploration* consumed
by schedule.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import DataflowGraph, Task, idx
from .patterns import STENCIL_REREAD, fine_violations

_BATCH_VARS = ("n", "b")

# Pipeline declaration consumed by passes.default_passes().  Stencil
# rewriting changes stream orders, so reuse invalidates fine's guarantees:
# the manager re-runs fine right after ("reinvokes the correctness passes
# to avoid new violations").
PASS_INFO = {
    "name": "reuse",
    "result_attr": "reuse_report",
    "option_flag": "communication",
    "invalidates": ("fine",),
    "description": "violation-free reuse-buffer generation (Fig. 7)",
}


@dataclass
class ReuseReport:
    rewritten: list[str] = field(default_factory=list)
    line_buffer_bytes: int = 0
    window_buffer_bytes: int = 0

    def summary(self) -> str:
        return (f"reuse: {len(self.rewritten)} stencil tasks rewritten, "
                f"lb={self.line_buffer_bytes}B wb={self.window_buffer_bytes}B")


def _stencil_read(task: Task):
    for a in task.reads:
        for dim in a.index:
            live = [v for (v, _s) in dim
                    if task.has_loop(v) and task.loop(v).trip > 1]
            if len(live) > 1:
                return a
    return None


def rewrite_stencil_task(graph: DataflowGraph, task: Task, itemsize: int = 4
                         ) -> tuple[int, int] | None:
    """Apply Fig. 7's rewrite to one windowed task.  Returns (line, window)
    buffer sizes in bytes, or None when the task has no stencil read."""
    read = _stencil_read(task)
    if read is None:
        return None
    write = task.writes[0]
    trips = {l.var: l.trip for l in task.loops}

    # Classify vars.  For conv: spatial = (h,w) [stencil outer vars],
    # kernel = (kh,kw) [stencil inner vars], ci = read channel, co = write channel.
    spatial, kernel, new_index, stream_shape = [], [], [], []
    for dim in read.index:
        live = [(v, s) for (v, s) in dim if trips.get(v, 1) > 1]
        span = 1 + sum((trips[v] - 1) * abs(s) for (v, s) in live)
        stream_shape.append(span)
        if len(live) > 1:
            # outermost var is the sliding position, the rest the window
            live_sorted = sorted(live, key=lambda vs: task.loop_depth(vs[0]))
            pos, win = live_sorted[0], live_sorted[1:]
            spatial.append(pos[0])
            kernel += [v for (v, _s) in win]
            new_index.append(idx(pos))
        else:
            new_index.append(idx(*live) if live else ())
    read_only = read.vars() - write.vars()          # e.g. {ci, kh, kw}
    write_only = write.vars() - read.vars()         # e.g. {co}
    ci_vars = [v for v in read_only if v not in kernel and v not in spatial]
    batch = [v for v in (read.vars() & write.vars())
             if v not in spatial and v not in kernel]

    # --- new loop order (Fig. 7): batch, spatial, [load ci | compute co,ci,k...]
    depth0 = {l.var: i for i, l in enumerate(task.loops)}

    def order_key(l):
        if l.var in batch:
            return (0, depth0[l.var])
        if l.var in spatial:
            return (1, depth0[l.var])
        if l.var in write_only:
            return (2, depth0[l.var])
        if l.var in ci_vars:
            return (3, depth0[l.var])
        return (4, depth0[l.var])

    task.loops.sort(key=order_key)

    # --- ring classification (parallelism-exploration guidance, Fig. 7 text)
    for l in task.loops:
        if l.var in batch:
            l.ring = "outer"            # red: unrolls all regions — unsafe
        elif l.var in spatial or l.var in ci_vars or l.var in write_only:
            l.ring = "fifo"             # orange: tied to FIFO indices
        else:
            l.ring = "reduction"        # green: safe to parallelize

    # --- exact-once read: the load region consumes the full *input* extent
    # (stream_shape keeps the pre-rewrite spans, e.g. padded rows)
    read.index = tuple(new_index)
    read.enclosing = tuple(v for v in (batch + spatial + ci_vars))
    read.stream_shape = tuple(stream_shape)
    # --- write region runs under (batch, spatial, co): once per element
    write.enclosing = tuple(v for v in (batch + spatial + [x for x in write_only]))

    # --- reuse-buffer shapes (lb: kh-1 rows × row length; wb: window)
    k_trips = [trips[v] for v in kernel]
    row = 1
    if len(spatial) >= 1:
        innermost_spatial = spatial[-1]
        row = trips[innermost_spatial]
    ci_sz = 1
    for v in ci_vars:
        ci_sz *= trips[v]
    kh = k_trips[0] if k_trips else 1
    kw = k_trips[1] if len(k_trips) > 1 else 1
    lb = ci_sz * max(kh - 1, 1) * row
    wb = ci_sz * kh * kw
    task.reuse_buffers[f"lb_{read.buffer}"] = (ci_sz, max(kh - 1, 1), row)
    task.reuse_buffers[f"wb_{read.buffer}"] = (ci_sz, kh, kw)
    task.tags.add("reuse-rewritten")
    return lb * itemsize, wb * itemsize


def generate_reuse_buffers(graph: DataflowGraph) -> ReuseReport:
    """Rewrite every task holding a STENCIL_REREAD violation; also rewrite
    stencil reads of *external* inputs (profitable even without a FIFO peer
    — the reuse itself saves bandwidth, 'also applicable when the target
    array is implemented using ping-pong buffers')."""
    report = ReuseReport()
    flagged: set[str] = set()
    for v in fine_violations(graph):
        if v.kind == STENCIL_REREAD:
            flagged.add(v.consumer)
    for t in graph.tasks:
        if t.name in flagged or _stencil_read(t) is not None:
            r = rewrite_stencil_task(graph, t)
            if r is not None:
                report.rewritten.append(t.name)
                report.line_buffer_bytes += r[0]
                report.window_buffer_bytes += r[1]
    return report


def parallel_safety(task: Task, var: str) -> str:
    """Scheduler query: 'unsafe' | 'coordinate' | 'free' (Fig. 7 guidance +
    §V-B legality: no loop-carried deps; FIFO-indexed vars need peer
    coordination)."""
    l = task.loop(var)
    if l.ring == "outer" or "fused-control" in task.tags:
        return "unsafe"
    if l.ring == "fifo":
        return "coordinate"
    # free/reduction rings: legal if no carried dependency; reductions are
    # associative here (MAC trees), matching the paper's treatment.
    return "free"
