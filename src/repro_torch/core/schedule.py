"""Automated dataflow scheduling (paper §VI): resource-aware,
bottleneck-centric DSE in three stages, then inter-task propagation.

* **PA — initial parallelism allocation**: estimate every task's latency at
  degree 1 with the profiling-based model, allocate degrees proportional to
  latency (min degree 1), then scale all degrees up preserving ratios until
  the unit budget or per-task caps bind.
* **UP — upscaling**: while a bottleneck loop is ≥ n× slower than the
  fastest, double its degree (the paper's minimum unroll granularity is 2,
  hence n = 2.0) until stable or iteration limit.
* **DP — downscaling**: a task n× faster than the longest has been
  over-optimized; halve its degree while it stays under the bottleneck
  latency, reclaiming units.  Optional (users may disable for max perf).
* **Inter-task optimization**: parallelizing a FIFO-indexed loop changes
  the stream's element order/rate, so the chosen degree is propagated to
  the FIFO peer's matching loop.  Unresolvable conflicts downgrade the edge
  to ping-pong (§VI's A-B-C-D example), preserving the upstream FIFO chain.

Degrees are realized on concrete loops respecting reuse.py's safety rings:
``reduction``/``free`` loops first (green — always legal), then ``fifo``
loops (orange — legal with peer coordination), never ``outer`` (red).

The same engine assigns **pipeline stages** (for the multi-chip pipeline
executor): contiguous topo segments balanced by scheduled latency.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .buffers import BufferPlan, downgrade_to_pingpong
from .costmodel import V5E, GraphCost, HwParams, graph_latency, task_cost
from .graph import FIFO, DataflowGraph, Task
from .patterns import fine_violations
from .reuse import parallel_safety

N_BALANCE = 2.0          # the paper's empirically-set balancing threshold
UP_ITER_LIMIT = 32
_POW2 = [2 ** k for k in range(16)]

# Pipeline declaration consumed by passes.default_passes().
PASS_INFO = {
    "name": "schedule",
    "result_attr": "schedule_report",
    "option_flag": "scheduling",
    "invalidates": (),
    "description": "automated dataflow scheduling (PA/UP/DP + inter-task, §VI)",
}


@dataclass
class ScheduleReport:
    stage_latencies: dict[str, float] = field(default_factory=dict)   # after each stage
    degrees: dict[str, int] = field(default_factory=dict)
    propagated: list[str] = field(default_factory=list)
    downgraded: list[str] = field(default_factory=list)
    units_used: int = 0
    up_iters: int = 0

    def summary(self) -> str:
        lat = " -> ".join(f"{k}:{v:,.0f}" for k, v in self.stage_latencies.items())
        return (f"schedule: {lat}; units={self.units_used}, "
                f"{len(self.propagated)} propagated, {len(self.downgraded)} downgraded")

    # ---- JSON serialization (docs/artifact_format.md `schedule`) ---------
    def to_dict(self) -> dict:
        return {"stage_latencies": dict(self.stage_latencies),
                "degrees": dict(self.degrees),
                "propagated": list(self.propagated),
                "downgraded": list(self.downgraded),
                "units_used": self.units_used, "up_iters": self.up_iters}

    @classmethod
    def from_dict(cls, doc: dict) -> "ScheduleReport":
        # Canonical JSON sorts object keys, so restore the semantic
        # base → PA → UP → DP → final stage order on the way in.
        raw = doc.get("stage_latencies", {})
        order = [k for k in ("base", "PA", "UP", "DP", "final") if k in raw]
        order += [k for k in raw if k not in order]
        return cls(
            stage_latencies={k: float(raw[k]) for k in order},
            degrees={k: int(v) for k, v in doc.get("degrees", {}).items()},
            propagated=list(doc.get("propagated", ())),
            downgraded=list(doc.get("downgraded", ())),
            units_used=int(doc.get("units_used", 0)),
            up_iters=int(doc.get("up_iters", 0)))


# --------------------------------------------------------------------------
# Degree realization on loops
# --------------------------------------------------------------------------


def parallelizable_loops(task: Task) -> list:
    """Loops legal to parallelize, green ring first (Fig. 7 guidance)."""
    greens = [l for l in task.loops if parallel_safety(task, l.var) == "free"
              and l.trip > 1]
    oranges = [l for l in task.loops if parallel_safety(task, l.var) == "coordinate"
               and l.trip > 1]
    return greens + oranges


def max_task_degree(task: Task) -> int:
    cap = 1
    for l in parallelizable_loops(task):
        cap *= l.trip
    return cap


def apply_degree(task: Task, degree: int) -> int:
    """Distribute ``degree`` over legal loops innermost-first (powers of 2,
    clipped to trip counts).  Returns the realized degree."""
    for l in task.loops:
        l.parallel = 1
    remaining = max(1, degree)
    realized = 1
    for l in reversed(parallelizable_loops(task)):
        if remaining <= 1:
            break
        d = 1
        while d * 2 <= min(remaining, l.trip):
            d *= 2
        l.parallel = d
        realized *= d
        remaining //= d
    return realized


# --------------------------------------------------------------------------
# Stage 1: PA
# --------------------------------------------------------------------------


def initial_allocation(graph: DataflowGraph, hw: HwParams, budget: int,
                       max_degree: int) -> dict[str, int]:
    base = {t.name: task_cost(graph, t, hw).latency for t in graph.tasks}
    lmin = max(min(base.values()), 1.0)
    # proportional degrees, min 1 (paper: "in proportion to their latencies,
    # setting the smallest degree to 1")
    prop = {n: max(1.0, lat / lmin) for n, lat in base.items()}
    caps = {t.name: min(max_degree, max_task_degree(t)) for t in graph.tasks}

    # gradually scale up preserving ratios until the budget or caps bind
    def realized(scale: float) -> dict[str, int]:
        out = {}
        for n, p in prop.items():
            d = 2 ** int(math.floor(math.log2(max(1.0, p * scale))))
            out[n] = int(min(d, caps[n]))
        return out

    scale = 1.0
    best = realized(scale)
    # scale *down* first if the raw proportional allocation already blows
    # the budget (highly imbalanced graphs), preserving the ratios
    while sum(best.values()) > budget and scale > 2 ** -24:
        scale /= 2
        best = realized(scale)
    while True:
        trial = realized(scale * 2)
        if sum(trial.values()) > budget or trial == best:
            break
        best, scale = trial, scale * 2
        if scale > 2 ** 24:
            break
    return best


# --------------------------------------------------------------------------
# Stage 2 / 3: UP & DP
# --------------------------------------------------------------------------


def _evaluate(graph: DataflowGraph, degrees: dict[str, int], hw: HwParams,
              plan: BufferPlan | None) -> GraphCost:
    for t in graph.tasks:
        apply_degree(t, degrees[t.name])
    return graph_latency(graph, hw, plan)


def upscale(graph: DataflowGraph, degrees: dict[str, int], hw: HwParams,
            plan: BufferPlan | None, budget: int, max_degree: int,
            n: float = N_BALANCE) -> int:
    caps = {t.name: min(max_degree, max_task_degree(t)) for t in graph.tasks}
    iters = 0
    for iters in range(1, UP_ITER_LIMIT + 1):
        gc = _evaluate(graph, degrees, hw, plan)
        lat = {k: c.latency for k, c in gc.costs.items()}
        lmin = min(lat.values())
        # bottleneck loops at least n× slower than the fastest
        hot = sorted((k for k in lat if lat[k] >= n * lmin and
                      degrees[k] * 2 <= caps[k]),
                     key=lambda k: -lat[k])
        if not hot or sum(degrees.values()) >= budget:
            break
        k = hot[0]
        if sum(degrees.values()) - degrees[k] + degrees[k] * 2 > budget:
            break
        degrees[k] *= 2
    return iters


def downscale(graph: DataflowGraph, degrees: dict[str, int], hw: HwParams,
              plan: BufferPlan | None, n: float = N_BALANCE) -> None:
    changed = True
    while changed:
        changed = False
        gc = _evaluate(graph, degrees, hw, plan)
        lat = {k: c.latency for k, c in gc.costs.items()}
        lmax = max(lat.values())
        for k in sorted(lat, key=lambda k: lat[k]):
            if degrees[k] <= 1:
                continue
            if lat[k] * n <= lmax:
                # halving at most doubles this task's latency; legal while
                # it stays under the bottleneck
                if lat[k] * 2.0 <= lmax:
                    degrees[k] //= 2
                    changed = True


# --------------------------------------------------------------------------
# Inter-task optimization (§VI last part)
# --------------------------------------------------------------------------


def _edge_dim_peer(graph: DataflowGraph, p: Task, buf: str, c: Task
                   ) -> list[tuple[str, str]]:
    """(producer_var, consumer_var) pairs driving the same buffer dim."""
    w = p.writes_to(buf)[0]
    r = c.reads_from(buf)[0]
    pairs = []
    for dw, dr in zip(w.index, r.index):
        pv = [v for (v, _s) in dw if p.has_loop(v) and p.loop(v).trip > 1]
        cv = [v for (v, _s) in dr if c.has_loop(v) and c.loop(v).trip > 1]
        if len(pv) == 1 and len(cv) == 1:
            pairs.append((pv[0], cv[0]))
    return pairs


def propagate_intertask(graph: DataflowGraph, plan: BufferPlan,
                        report: ScheduleReport, budget: int | None = None
                        ) -> None:
    """Propagate fifo-loop parallel degrees across FIFO edges; downgrade on
    conflict.  The *bottleneck* side of the edge keeps its degree and the
    peer adopts it — coordination must never de-parallelize the critical
    task (raising a cheap peer costs few units; report records overruns)."""
    from .costmodel import task_cost

    for _round in range(8):
        changed = False
        for p, buf, c in graph.internal_edges():
            if plan.impl.get(buf) != FIFO:
                continue
            for pv, cv in _edge_dim_peer(graph, p, buf, c):
                pl, cl = p.loop(pv), c.loop(cv)
                if pl.ring != "fifo" and cl.ring != "fifo":
                    continue
                if pl.parallel == cl.parallel:
                    continue
                bottleneck_is_p = (task_cost(graph, p).latency
                                   >= task_cost(graph, c).latency)
                target = pl.parallel if bottleneck_is_p else cl.parallel
                for (t, l) in ((p, pl), (c, cl)):
                    if l.parallel == target:
                        continue
                    if parallel_safety(t, l.var) == "unsafe" or target > l.trip:
                        downgrade_to_pingpong(graph, plan, buf,
                                              f"inter-task conflict on {l.var}")
                        report.downgraded.append(buf)
                        break
                else:
                    pl.parallel = cl.parallel = target
                    report.propagated.append(f"{buf}:{pv}->{cv}={target}")
                    changed = True
        if not changed:
            break


# --------------------------------------------------------------------------
# Pipeline-stage assignment (feeds core/pipeline.py)
# --------------------------------------------------------------------------


def assign_stages(graph: DataflowGraph, hw: HwParams, num_stages: int) -> list[list[str]]:
    """Contiguous topo segments with balanced scheduled latency."""
    order = graph.toposort()
    lats = [task_cost(graph, t, hw).latency for t in order]
    total = sum(lats)
    target = total / max(1, num_stages)
    stages: list[list[str]] = [[] for _ in range(num_stages)]
    acc, si = 0.0, 0
    for t, lat in zip(order, lats):
        if acc > target * (si + 1) and si < num_stages - 1:
            si += 1
        stages[si].append(t.name)
        t.stage = si
        acc += lat
    return stages


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def autoschedule(graph: DataflowGraph, plan: BufferPlan | None = None,
                 hw: HwParams = V5E, budget: int | None = None,
                 max_degree: int = 4096, n: float = N_BALANCE,
                 enable_up: bool = True, enable_dp: bool = True,
                 ) -> ScheduleReport:
    budget = budget if budget is not None else hw.max_units
    report = ScheduleReport()

    base = _evaluate(graph, {t.name: 1 for t in graph.tasks}, hw, plan)
    report.stage_latencies["base"] = base.total_cycles

    degrees = initial_allocation(graph, hw, budget, max_degree)
    pa = _evaluate(graph, degrees, hw, plan)
    report.stage_latencies["PA"] = pa.total_cycles

    if enable_up:
        report.up_iters = upscale(graph, degrees, hw, plan, budget, max_degree, n)
        up = _evaluate(graph, degrees, hw, plan)
        report.stage_latencies["UP"] = up.total_cycles

    if enable_dp:
        downscale(graph, degrees, hw, plan, n)
        dp = _evaluate(graph, degrees, hw, plan)
        report.stage_latencies["DP"] = dp.total_cycles

    if plan is not None:
        propagate_intertask(graph, plan, report, budget)
        # re-run correctness detection after structural changes (§VI:
        # "reinvoke our correctness passes")
        leftover = fine_violations(graph)
        for v in leftover:
            if plan.impl.get(v.buffer) == FIFO:
                downgrade_to_pingpong(graph, plan, v.buffer,
                                      f"post-schedule violation {v.kind}")
                report.downgraded.append(v.buffer)

    final = graph_latency(graph, hw, plan)
    report.stage_latencies["final"] = final.total_cycles
    report.degrees = {t.name: max(1, int(__import__('numpy').prod([l.parallel for l in t.loops])))
                      for t in graph.tasks}
    report.units_used = sum(report.degrees.values())
    return report
