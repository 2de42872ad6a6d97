"""Pattern-directed kernel routing for fusion groups (paper §VII-C).

The lowering forms *fusion groups* — maximal FIFO-connected task sets whose
intermediates never round-trip through HBM.  This module decides **which
implementation executes each group**: a hand-written CUDA kernel when
the group contains a producer→consumer chain matching a registered
:class:`KernelPattern`, the generic task-by-task composition (still named
``xla-fused``, so routing tables compare like for like with the JAX
reference) otherwise.  HIDA and FLOWER both map fused dataflow nodes onto specialized
implementations the same way — pattern match first, fall back second —
and it is where the measured latency wins come from.

Pattern language
----------------

A pattern is a tuple of items matched against a *chain* of tasks (each
task's output feeding exactly the next task) inside one fusion group:

* ``"matmul"``   — exactly one task whose ``Task.op`` is ``matmul``;
* ``"*ewise"``   — zero or more consecutive ``ewise`` tasks (wildcard).

``("matmul", "*ewise", "matmul")`` therefore matches a bare matmul→matmul
chain as well as matmul→gelu→matmul.  Chains must be exclusive: every
interior buffer is single-consumer and not a graph output, so replacing
the matched tasks with one kernel step that emits only the final buffer
is always sound.  Interior edges may be FIFO *or* ping-pong: a ping-pong
edge means the generic path must materialize the intermediate in HBM
(broadcast/stencil re-read), and absorbing that round-trip into the
kernel's on-chip working set is exactly the §VII-C win.

Feasibility
-----------

Matching is structural; whether a *specific* group instance can use the
kernel (shapes, dtypes, strides, a tiling that fits) is the pattern's
``feasible(graph, tasks)`` guard — pure graph analysis, so this module
imports no torch.  The ``factory(graph, group, tasks)`` that builds the
executable step is only called from the lowering.

Cost gate
-------------------

A structural match is necessary but not sufficient: each matched chain is
priced both ways by the cost model (:func:`repro_torch.core.costmodel.
estimate_chain`) and routed only on predicted win — small chains whose
dispatch overhead would dominate, and patterns the calibration says lose
on this backend, fall back to the generic path.  A
measured :class:`~repro_torch.core.tuning.TuningDB` verdict beats the
predictor when one exists for the chain's structural signature.

Escape hatches
--------------

``CODO_DISABLE_PALLAS=1`` disables all routing — every group falls back
to ``xla-fused``.  ``CODO_FORCE_PALLAS=1`` routes every structural match
regardless of the gate's prediction (disable wins over force).  Both
flags — plus the registry epoch, the priced backend (``cuda`` for a
program on the card, ``cpu`` otherwise, ``CODO_BACKEND`` overriding), the
calibration digest, and the tuning-DB digest — enter the lowering memo key via
:func:`routing_state_key`, so toggling any of them never serves a stale
program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .graph import FIFO, DataflowGraph, Task

XLA_FUSED = "xla-fused"
WILDCARD = "*"


def _truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def pallas_disabled() -> bool:
    """The ``CODO_DISABLE_PALLAS`` escape hatch: truthy values route every
    fusion group to the generic ``xla-fused`` path."""
    return _truthy("CODO_DISABLE_PALLAS")


def pallas_forced() -> bool:
    """The ``CODO_FORCE_PALLAS`` override: truthy values route every
    structural match regardless of the cost gate's prediction (useful for
    A/B measurement and for exercising kernels on shapes the gate would
    reject).  :func:`pallas_disabled` wins when both are set."""
    return _truthy("CODO_FORCE_PALLAS")


@dataclass(frozen=True)
class KernelPattern:
    """One routable kernel: a name, an op pattern, a torch-free feasibility
    guard, and a factory building the executable step.

    ``factory(graph, group, tasks)`` returns an ``env -> {out: tensor}``
    callable; returning ``None`` declines the
    match at build time (treated like an infeasible guard).  Patterns
    whose kernels take tile/block parameters declare a ``tiles(graph,
    tasks)`` candidate enumerator and accept the winning candidate as a
    ``tile=`` keyword on the factory (``None`` = kernel default).
    """

    name: str
    pattern: tuple[str, ...]
    factory: Callable[[DataflowGraph, Any, list[Task]], Callable | None]
    feasible: Callable[[DataflowGraph, list[Task]], bool] | None = None
    description: str = ""
    tiles: Callable[[DataflowGraph, list[Task]], list[dict | None]] | None = None
    # Recurrence kernels (rglru/ssd chunked scans) replace ONE task whose
    # generic form is sequential — for them a single-task "chain" is the
    # whole point, so they opt out of the >=2-task floor below.
    allow_single: bool = False

    def __post_init__(self):
        if not self.pattern:
            raise ValueError(f"pattern {self.name!r} is empty")
        if self.pattern[0].startswith(WILDCARD):
            raise ValueError(
                f"pattern {self.name!r} cannot start with a wildcard item "
                f"({self.pattern[0]!r}) — anchors would be ambiguous")


@dataclass
class RoutedKernel:
    """One gate decision inside a fusion group: a structurally matched
    chain, the cost model's verdict on it, and — when the decision came
    from the tuning database — the measured numbers.  Chains whose
    ``decision`` is in :data:`ROUTED_DECISIONS` execute as the registered
    kernel; the rest stay on the generic path (recorded for the
    diagnostics/--profile predicted-vs-measured table)."""

    kernel: str                  # KernelPattern.name
    tasks: list[str]             # matched chain, dataflow order
    decision: str = "predicted-win"
    predicted_routed_cycles: float = 0.0
    predicted_generic_cycles: float = 0.0
    tile: dict | None = None     # tuned blocking (None = kernel default)
    measured_speedup: float | None = None   # generic/routed, tuning DB

    @property
    def routed(self) -> bool:
        return self.decision in ROUTED_DECISIONS

    def to_dict(self) -> dict:
        out = {"kernel": self.kernel, "tasks": list(self.tasks),
               "decision": self.decision,
               "predicted_routed_cycles": round(
                   self.predicted_routed_cycles, 1),
               "predicted_generic_cycles": round(
                   self.predicted_generic_cycles, 1)}
        if self.tile is not None:
            out["tile"] = dict(self.tile)
        if self.measured_speedup is not None:
            out["measured_speedup"] = round(self.measured_speedup, 4)
        return out


# Decisions that put a chain on the kernel path; everything else
# ("predicted-loss", "tuned-generic") stays generic.
ROUTED_DECISIONS = frozenset({"predicted-win", "forced", "tuned"})


# --------------------------------------------------------------------------
# Registry.  Ordered by registration; first matching pattern wins at every
# anchor task.  The epoch bumps on every (re-)registration so memoized
# lowerings built against an older registry are never served.
# --------------------------------------------------------------------------

_PATTERNS: dict[str, KernelPattern] = {}
_EPOCH = 0
_WIRED = False


def ensure_kernel_patterns() -> None:
    """One-time registration of the shipped kernel patterns
    (``repro_torch.kernels.register_all``).  Called by every routing
    consumer — lowering and ``route_plan`` — so the compiler, not the user,
    wires the kernels in.  A failed import propagates: an empty registry
    would quietly run every chain generically and hide a missing kernel."""
    global _WIRED
    if _WIRED:
        return
    from .. import kernels
    kernels.register_all()
    _WIRED = True


def register_kernel_pattern(pattern: KernelPattern) -> KernelPattern:
    global _EPOCH
    _PATTERNS[pattern.name] = pattern
    _EPOCH += 1
    return pattern


def registered_patterns() -> list[KernelPattern]:
    return list(_PATTERNS.values())


def routing_epoch() -> int:
    return _EPOCH


def clear_kernel_patterns() -> None:
    """Testing hook: drop every registered pattern (bumps the epoch so
    memoized lowerings notice)."""
    global _EPOCH
    _PATTERNS.clear()
    _EPOCH += 1


# --------------------------------------------------------------------------
# Matching
# --------------------------------------------------------------------------


def _sole_output(task: Task) -> str | None:
    outs = {a.buffer for a in task.writes}
    return next(iter(outs)) if len(outs) == 1 else None


def _chain_next(graph: DataflowGraph, members: set[str], impl: dict[str, str],
                task: Task) -> Task | None:
    """The unique task that streams ``task``'s output onward, or ``None``.

    The edge qualifies only when the intermediate can disappear into a
    kernel: one output buffer, not a graph output, read by exactly one
    consumer — which must be in the same group.  The buffer's planned impl
    does not matter: a FIFO intermediate folds into the kernel's on-chip
    stream, and a ping-pong one (a broadcast/stencil re-read the generic
    path must materialize in HBM) is absorbed by the kernel's on-chip
    working set — that HBM round-trip removed is where the kernel wins
    (e.g. the softmax·matmul tail never materializes the probabilities).
    """
    buf = _sole_output(task)
    if buf is None:
        return None
    if graph.buffers[buf].kind == "output":
        return None
    consumers = graph.consumers(buf)
    if len(consumers) != 1 or consumers[0].name not in members:
        return None
    return consumers[0]


def _match_chain(graph: DataflowGraph, members: set[str],
                 impl: dict[str, str], start: Task,
                 pattern: Sequence[str]) -> list[Task] | None:
    """Match ``pattern`` against the chain anchored at ``start``.

    Wildcard items are greedy with backtracking-by-construction: a
    ``"*op"`` consumes chain tasks of that op until the next literal item
    matches (the wildcard op and the following literal op are distinct in
    every registered pattern, so greediness is exact, not heuristic).
    """
    matched: list[Task] = []
    cur: Task | None = start
    items = list(pattern)
    for i, item in enumerate(items):
        if item.startswith(WILDCARD):
            want = item[1:]
            while cur is not None and cur.op == want:
                matched.append(cur)
                cur = _chain_next(graph, members, impl, cur)
            continue
        if cur is None or cur.op != item:
            return None
        matched.append(cur)
        if i + 1 < len(items):
            cur = _chain_next(graph, members, impl, cur)
    if len(matched) > 1 and not _chain_is_exclusive(matched):
        return None
    return matched


def _chain_is_exclusive(tasks: list[Task]) -> bool:
    """Interior buffers must reach each successor only as its single
    streamed (chain) operand.  A task that reads the chain value through
    a *second* operand slot (``p @ p``) or reaches back to an earlier
    interior buffer cannot be replaced by a kernel that never emits the
    interiors — the generic path handles those graphs instead."""
    outs = [_sole_output(t) for t in tasks[:-1]]
    interior = set(outs)
    for i, t in enumerate(tasks):
        chain_in = outs[i - 1] if i > 0 else None
        reads = [a.buffer for a in t.reads]
        if chain_in is not None and reads.count(chain_in) > 1:
            return False
        if any(b in interior and b != chain_in for b in reads):
            return False
    return True


def match_group(graph: DataflowGraph, group_tasks: Sequence[str],
                impl: dict[str, str], *,
                patterns: Sequence[KernelPattern] | None = None,
                ) -> list[tuple[KernelPattern, list[Task]]]:
    """All non-overlapping pattern matches inside one fusion group.

    Two phases, purely structural (no kernel construction):
    every (anchor, pattern) pair is first matched independently, then
    candidates claim tasks **longest chain first** (ties: anchor topo
    order, then pattern registration order).  Longest-first is what lets
    a wide pattern supersede narrower ones over the same tasks — e.g.
    ``flashattn.mha`` takes ``matmul→scale→softmax→matmul`` whole even
    though ``streamfuse.mmchain`` could claim the score matmul from the
    projection anchor and ``streamfuse.softmaxmm`` could claim the tail.
    The result is returned in anchor topo order.
    """
    pats = list(patterns) if patterns is not None else registered_patterns()
    if not pats:
        return []
    members = set(group_tasks)
    candidates: list[tuple[int, int, int, KernelPattern, list[Task]]] = []
    for a_idx, name in enumerate(group_tasks):
        anchor = graph.task(name)
        for p_idx, pat in enumerate(pats):
            tasks = _match_chain(graph, members, impl, anchor, pat.pattern)
            min_len = 1 if pat.allow_single else 2
            if not tasks or len(tasks) < min_len:
                continue            # single-task "chains" stay generic
            if pat.feasible is not None and not pat.feasible(graph, tasks):
                continue
            candidates.append((-len(tasks), a_idx, p_idx, pat, tasks))
    claimed: set[str] = set()
    out: list[tuple[int, KernelPattern, list[Task]]] = []
    for neg_len, a_idx, _p_idx, pat, tasks in sorted(
            candidates, key=lambda c: c[:3]):
        if any(t.name in claimed for t in tasks):
            continue
        claimed.update(t.name for t in tasks)
        out.append((a_idx, pat, tasks))
    return [(pat, tasks) for _a, pat, tasks in sorted(out,
                                                      key=lambda c: c[0])]


def decide_route(graph: DataflowGraph, tasks: list[Task],
                 pattern: KernelPattern, *, hw=None, params=None,
                 db=None, backend: str | None = None) -> RoutedKernel:
    """The cost gate for one structurally matched chain.

    Precedence: a measured :class:`~repro_torch.core.tuning.TuningDB` entry for
    the chain's signature on this backend/hardware (``tuned`` /
    ``tuned-generic``), then the ``CODO_FORCE_PALLAS`` override
    (``forced``), then the predictor (``predicted-win`` /
    ``predicted-loss``).  The predicted cycles are recorded on the result
    either way.
    """
    from .costmodel import V5E, estimate_chain, routing_backend
    from .tuning import chain_signature, default_tuning_db
    hw = hw if hw is not None else V5E
    backend = backend or routing_backend()
    est = estimate_chain(graph, tasks, pattern.name, hw, params)
    route = RoutedKernel(pattern.name, [t.name for t in tasks],
                         predicted_routed_cycles=est.routed_cycles,
                         predicted_generic_cycles=est.generic_cycles)
    if db is None:
        db = default_tuning_db()
    rec = db.lookup(chain_signature(graph, tasks), backend, hw.name)
    if rec is not None:
        route.decision = "tuned" if rec.choice == "pallas" else "tuned-generic"
        route.tile = dict(rec.tile) if rec.tile else None
        route.measured_speedup = rec.speedup
    elif pallas_forced():
        route.decision = "forced"
    else:
        route.decision = "predicted-win" if est.win else "predicted-loss"
    return route


def route_groups(graph: DataflowGraph, groups, impl: dict[str, str], *,
                 enabled: bool | None = None, hw=None, params=None,
                 db=None, backend: str | None = None) -> None:
    """Annotate each :class:`~repro_torch.core.lowering.FusionGroup` in
    ``groups`` with its routing decision: cost-gate-accepted chains in
    ``routes``, gate-rejected structural matches in ``rejected``, and the
    group-level predicted cycles both ways.

    ``enabled=None`` consults :func:`pallas_disabled`.  ``backend`` is the
    one the gate prices against (:func:`~repro_torch.core.costmodel.
    routing_backend` when ``None``).  Only the lowering turns the resulting
    decisions into executable steps.
    """
    from .costmodel import V5E, routing_params, task_cost
    if enabled is None:
        enabled = not pallas_disabled()
    if params is None and enabled:
        params = routing_params(backend)
    hw_ = hw if hw is not None else V5E
    for g in groups:
        g.routes, g.rejected = [], []
        g.kernel = XLA_FUSED
        g.decision = "disabled" if not enabled else "generic"
        chained: set[str] = set()
        if enabled and g.tasks:
            for pat, tasks in match_group(graph, g.tasks, impl):
                route = decide_route(graph, tasks, pat, hw=hw,
                                     params=params, db=db, backend=backend)
                (g.routes if route.routed else g.rejected).append(route)
                if route.routed:
                    chained.update(route.tasks)
        # Group-level estimate: unmatched/rejected tasks run generically
        # on both sides; accepted chains contribute their two estimates.
        rest = sum(task_cost(graph, graph.task(n), hw_).latency
                   for n in g.tasks if n not in chained)
        g.predicted_generic_cycles = rest + sum(
            r.predicted_generic_cycles for r in g.routes)
        g.predicted_routed_cycles = rest + sum(
            r.predicted_routed_cycles for r in g.routes)
        if g.routes:
            g.kernel = "pallas:" + "+".join(r.kernel for r in g.routes)
            g.decision = "routed"


def fifo_groups(graph: DataflowGraph, impl: dict[str, str]) -> list[list[str]]:
    """Maximal FIFO-connected task sets in topo order: tasks unioned across
    FIFO edges (single-producer-single-consumer by construction after the
    coarse pass).  Pure; ``lowering.fusion_groups`` stamps the ids onto the
    tasks."""
    parent = {t.name: t.name for t in graph.tasks}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p, buf, c in graph.internal_edges():
        if impl.get(buf) == FIFO:
            parent[find(p.name)] = find(c.name)

    order = [t.name for t in graph.toposort()]
    by_root: dict[str, list[str]] = {}
    for n in order:
        by_root.setdefault(find(n), []).append(n)
    pos = {n: i for i, n in enumerate(order)}
    return sorted(by_root.values(), key=lambda names: pos[names[0]])


def route_plan(graph: DataflowGraph, impl: dict[str, str], *,
               enabled: bool | None = None, hw=None, params=None,
               db=None, backend: str | None = None) -> list[dict]:
    """The per-group routing table for a compiled design, as plain data.
    Group membership is :func:`fifo_groups` (what ``lowering.
    fusion_groups`` uses, without mutating task ``fused_group`` ids); the
    cost gate (and tuning DB) apply exactly as in :func:`route_groups`."""
    from .costmodel import routing_params
    ensure_kernel_patterns()
    if enabled is None:
        enabled = not pallas_disabled()
    if params is None and enabled:
        params = routing_params(backend)
    plan = []
    for gid, names in enumerate(fifo_groups(graph, impl)):
        routes: list[RoutedKernel] = []
        rejected: list[RoutedKernel] = []
        if enabled and names:
            for pat, tasks in match_group(graph, names, impl):
                route = decide_route(graph, tasks, pat, hw=hw,
                                     params=params, db=db, backend=backend)
                (routes if route.routed else rejected).append(route)
        kernel = ("pallas:" + "+".join(r.kernel for r in routes)
                  if routes else XLA_FUSED)
        plan.append({"gid": gid, "tasks": list(names), "kernel": kernel,
                     "routes": [r.to_dict() for r in routes],
                     "rejected": [r.to_dict() for r in rejected]})
    return plan


def routing_state_key(backend: str | None = None) -> tuple:
    """Every switch a routing decision can depend on — the lowering memo
    key ingredient.  Covers the disable/force escape hatches, the
    pattern-registry epoch, the priced backend, the active calibration
    constants, and the tuning-database contents: flipping any of them must
    never serve a stale program."""
    from .costmodel import routing_backend, routing_params
    from .tuning import default_tuning_db
    backend = backend or routing_backend()
    return (pallas_disabled(), pallas_forced(), routing_epoch(), backend,
            routing_params(backend).digest(), default_tuning_db().digest())


__all__ = ["KernelPattern", "ROUTED_DECISIONS", "RoutedKernel", "XLA_FUSED",
           "clear_kernel_patterns", "decide_route", "ensure_kernel_patterns",
           "fifo_groups", "match_group", "pallas_disabled", "pallas_forced",
           "register_kernel_pattern",
           "registered_patterns", "route_groups", "route_plan",
           "routing_epoch", "routing_state_key"]
