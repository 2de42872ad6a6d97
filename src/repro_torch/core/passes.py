"""Pass-manager infrastructure for the ``codo-opt`` pipeline.

The paper's compiler is a fixed six-stage pipeline (Fig. 3); Table VII's
Opt1..Opt5 ablations and Fig. 10's lessons come from running *subsets* of
it over many graphs.  This module turns the hardcoded call sequence of the
old ``codo_opt()`` into data:

* each transformation registers as a named :class:`Pass` with a declared
  result slot on :class:`~repro_torch.core.compiler.CompiledDataflow` and a
  declared set of *invalidations* — earlier passes whose guarantees it
  breaks.  ``reuse`` invalidates ``fine`` because stencil rewriting changes
  stream orders; the manager re-runs ``fine`` automatically and merges the
  reports (the paper: "reinvokes the correctness passes to avoid new
  violations").
* :class:`PassManager` executes the enabled subset in order, collecting a
  per-pass wall time and before/after violation census into a structured
  :class:`CompileDiagnostics`.
* :data:`ABLATION_PRESETS` is the Table VII grid as data: preset name →
  pass-name tuple.  ``CodoOptions.preset("opt3")`` reconstructs the
  corresponding option flags, so ablations never drift from the pipeline.

Pass metadata lives with each pass module (``PASS_INFO`` dicts in
coarse/fine/reuse/buffers/offchip/schedule) so a pass and its pipeline
declaration evolve together.
"""

from __future__ import annotations

import threading
import time
import tracemalloc
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from . import buffers as _buffers
from . import coarse as _coarse
from . import fine as _fine
from . import offchip as _offchip
from . import reuse as _reuse
from . import schedule as _schedule
from .patterns import coarse_violations, fine_violations

# Global execution census: pass name -> number of times the pass body ran
# in this process.  Tests use it to prove cache hits skip the pipeline.
PASS_RUN_COUNTS: Counter = Counter()
_COUNTS_LOCK = threading.Lock()


# --------------------------------------------------------------------------
# Pass + diagnostics
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Pass:
    """One named pipeline stage.

    ``run(graph, options, out)`` mutates ``graph`` in place and returns the
    pass report; the manager stores it on ``out.<result_attr>``.
    ``option_flag`` names the :class:`CodoOptions` boolean gating the pass
    (``None`` = always on).  ``invalidates`` lists earlier passes whose
    guarantees this pass breaks; the manager re-runs them right away.
    """

    name: str
    run: Callable[[Any, Any, Any], Any]
    result_attr: str | None = None
    option_flag: str | None = None
    invalidates: tuple[str, ...] = ()
    description: str = ""

    def enabled(self, options: Any) -> bool:
        if self.option_flag is None:
            return True
        return bool(getattr(options, self.option_flag))


def _budget_dims(raw) -> tuple[float, float, int]:
    """Normalize one ``CodoOptions.pass_budgets`` value to
    ``(seconds, mem_mb, violations)``.  A bare number is a wall-time
    budget (the original shape); a dict may set any of ``seconds``,
    ``mem_mb`` and ``violations``."""
    if isinstance(raw, dict):
        return (float(raw.get("seconds", 0.0)),
                float(raw.get("mem_mb", 0.0)),
                int(raw.get("violations", -1)))
    return float(raw or 0.0), 0.0, -1


@dataclass
class PassRecord:
    """Wall time + violation census for one pass execution."""

    name: str
    seconds: float
    coarse_before: int
    coarse_after: int
    fine_before: int
    fine_after: int
    rerun: bool = False        # re-execution triggered by an invalidation
    summary: str = ""
    budget: float = 0.0        # per-pass time budget in seconds (0 = none)
    # Structured budget dimensions (0 / -1 = unenforced).  mem_delta_mb is
    # the tracemalloc peak-over-entry python allocation during the pass,
    # measured only when a memory budget was requested (tracing costs
    # ~2x pass wall time, so it is opt-in per pass).
    mem_budget_mb: float = 0.0
    mem_delta_mb: float = 0.0
    violation_budget: int = -1  # cap on coarse+fine violations LEFT after

    @property
    def violations_after(self) -> int:
        """Census total after the pass (-1 when the census was off)."""
        if self.coarse_after < 0 or self.fine_after < 0:
            return -1
        return self.coarse_after + self.fine_after

    @property
    def over_time(self) -> bool:
        return self.budget > 0 and self.seconds > self.budget

    @property
    def over_memory(self) -> bool:
        return self.mem_budget_mb > 0 and self.mem_delta_mb > self.mem_budget_mb

    @property
    def over_violations(self) -> bool:
        return (self.violation_budget >= 0 and self.violations_after >= 0
                and self.violations_after > self.violation_budget)

    @property
    def over_budget(self) -> bool:
        return self.over_time or self.over_memory or self.over_violations

    def budget_problems(self) -> list[str]:
        """One phrase per exceeded budget dimension (empty = within)."""
        out = []
        if self.over_time:
            out.append(f"took {self.seconds * 1e3:.2f} ms > budget "
                       f"{self.budget * 1e3:.2f} ms")
        if self.over_memory:
            out.append(f"allocated {self.mem_delta_mb:.2f} MB > budget "
                       f"{self.mem_budget_mb:.2f} MB")
        if self.over_violations:
            out.append(f"left {self.violations_after} violation(s) > budget "
                       f"{self.violation_budget}")
        return out

    def line(self) -> str:
        tag = f"{self.name}*" if self.rerun else self.name
        census = ("" if self.coarse_before < 0 else
                  f"coarse {self.coarse_before:>3d}->{self.coarse_after:<3d} "
                  f"fine {self.fine_before:>3d}->{self.fine_after:<3d}  ")
        mem = (f" mem {self.mem_delta_mb:.2f} MB"
               if self.mem_budget_mb > 0 else "")
        over = (f"  OVER BUDGET ({'; '.join(self.budget_problems())})"
                if self.over_budget else "")
        return (f"{tag:<10s} {self.seconds * 1e3:8.2f} ms  "
                f"{census}{self.summary}{mem}{over}")

    def to_dict(self) -> dict:
        out = {"name": self.name, "seconds": self.seconds,
               "coarse_before": self.coarse_before,
               "coarse_after": self.coarse_after,
               "fine_before": self.fine_before, "fine_after": self.fine_after,
               "rerun": self.rerun, "summary": self.summary,
               "budget": self.budget}
        if self.mem_budget_mb > 0:
            out["mem_budget_mb"] = self.mem_budget_mb
            out["mem_delta_mb"] = self.mem_delta_mb
        if self.violation_budget >= 0:
            out["violation_budget"] = self.violation_budget
        return out

    @classmethod
    def from_dict(cls, doc: dict) -> "PassRecord":
        return cls(doc["name"], float(doc.get("seconds", 0.0)),
                   int(doc.get("coarse_before", -1)),
                   int(doc.get("coarse_after", -1)),
                   int(doc.get("fine_before", -1)),
                   int(doc.get("fine_after", -1)),
                   rerun=bool(doc.get("rerun", False)),
                   summary=doc.get("summary", ""),
                   budget=float(doc.get("budget", 0.0)),
                   mem_budget_mb=float(doc.get("mem_budget_mb", 0.0)),
                   mem_delta_mb=float(doc.get("mem_delta_mb", 0.0)),
                   violation_budget=int(doc.get("violation_budget", -1)))


@dataclass
class CompileDiagnostics:
    """Structured record of one ``codo_opt`` run (or cache hit)."""

    graph: str
    records: list[PassRecord] = field(default_factory=list)
    total_seconds: float = 0.0
    cache_hit: bool = False
    cache_key: str = ""
    # Kernel-routing record per fusion group (gid -> entry dict with the
    # winning "kernel", the cost gate's "decision", the predicted
    # routed/generic cycles, and the per-chain "routes"/"rejected"
    # verdicts).  Populated by lowering.lower() — empty until the design
    # has been lowered at least once.
    group_kernels: dict[str, dict] = field(default_factory=dict)

    @property
    def pass_names(self) -> list[str]:
        return [r.name for r in self.records]

    @property
    def pass_seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out

    def budget_violations(self) -> list[str]:
        """Human-readable line per pass execution that blew any budget
        dimension (time, memory delta, or remaining-violation count)."""
        return [f"{self.graph}: pass {r.name}{'*' if r.rerun else ''} "
                + "; ".join(r.budget_problems())
                for r in self.records if r.over_budget]

    def routed_kernels(self) -> dict[str, str]:
        """Only the groups routed off the generic path (gid -> kernel)."""
        return {gid: e["kernel"] for gid, e in self.group_kernels.items()
                if e.get("kernel", "xla-fused") != "xla-fused"}

    def summary(self) -> str:
        src = "cache" if self.cache_hit else f"{len(self.records)} passes"
        over = sum(1 for r in self.records if r.over_budget)
        routed = len(self.routed_kernels())
        return (f"diagnostics: {src}, {self.total_seconds * 1e3:.1f} ms "
                f"({' '.join(self.pass_names)})"
                + (f"; {over} over budget" if over else "")
                + (f"; {routed}/{len(self.group_kernels)} groups "
                   f"pallas-routed" if self.group_kernels else ""))

    def table(self) -> str:
        head = f"-- passes({self.graph}) --" + (" [cache hit]" if self.cache_hit else "")
        return "\n".join([head] + ["  " + r.line() for r in self.records])

    # ---- JSON serialization (docs/artifact_format.md `diagnostics`) ------
    def to_dict(self) -> dict:
        out = {"graph": self.graph,
               "records": [r.to_dict() for r in self.records],
               "total_seconds": self.total_seconds,
               "cache_hit": self.cache_hit, "cache_key": self.cache_key}
        if self.group_kernels:
            out["group_kernels"] = {k: dict(v)
                                    for k, v in self.group_kernels.items()}
        return out

    @classmethod
    def from_dict(cls, doc: dict) -> "CompileDiagnostics":
        # Pre-1.2 artifacts recorded bare kernel strings per gid; wrap
        # them in the entry shape so consumers see one format.
        kernels = {}
        for k, v in (doc.get("group_kernels") or {}).items():
            kernels[str(k)] = dict(v) if isinstance(v, dict) else {
                "kernel": str(v)}
        return cls(graph=doc.get("graph", "?"),
                   records=[PassRecord.from_dict(r)
                            for r in doc.get("records", ())],
                   total_seconds=float(doc.get("total_seconds", 0.0)),
                   cache_hit=bool(doc.get("cache_hit", False)),
                   cache_key=doc.get("cache_key", ""),
                   group_kernels=kernels)


# --------------------------------------------------------------------------
# Default pipeline (paper Fig. 3 order)
# --------------------------------------------------------------------------


def _make_pass(info: dict, run: Callable[[Any, Any, Any], Any]) -> Pass:
    return Pass(
        name=info["name"],
        run=run,
        result_attr=info.get("result_attr"),
        option_flag=info.get("option_flag"),
        invalidates=tuple(info.get("invalidates", ())),
        description=info.get("description", ""),
    )


def default_passes() -> list[Pass]:
    """The six paper passes, in Fig. 3 order, built from each module's
    ``PASS_INFO`` declaration."""
    return [
        _make_pass(_coarse.PASS_INFO,
                   lambda g, o, out: _coarse.eliminate_coarse(g)),
        _make_pass(_fine.PASS_INFO,
                   lambda g, o, out: _fine.eliminate_fine(g)),
        _make_pass(_reuse.PASS_INFO,
                   lambda g, o, out: _reuse.generate_reuse_buffers(g)),
        _make_pass(_buffers.PASS_INFO,
                   lambda g, o, out: _buffers.determine_buffers(g)),
        _make_pass(_offchip.PASS_INFO,
                   lambda g, o, out: _offchip.plan_offchip(g, o.hbm_channels)),
        _make_pass(_schedule.PASS_INFO,
                   lambda g, o, out: _schedule.autoschedule(
                       g, out.buffer_plan, o.hw, o.budget_units, o.max_degree,
                       o.balance_n, o.enable_up, o.enable_dp)),
    ]


# Default per-pass wall-time budgets in seconds, used when budget
# enforcement is requested without explicit limits (CLI --enforce-budgets).
# Generous on purpose: they exist to catch pathological regressions (a pass
# going quadratic on a big graph), not to flag normal variance.  Override
# per compile via ``CodoOptions.pass_budgets``.
DEFAULT_PASS_BUDGETS: dict[str, float] = {
    "coarse": 2.0, "fine": 2.0, "reuse": 2.0,
    "buffers": 1.0, "offchip": 1.0, "schedule": 5.0,
}


# Table VII ablation grid as data: preset -> enabled pass names.
# (buffers always runs: even Opt1/Opt2 need an edge implementation to cost.)
ABLATION_PRESETS: dict[str, tuple[str, ...]] = {
    "opt1": ("fine", "buffers"),
    "opt2": ("coarse", "buffers"),
    "opt3": ("coarse", "reuse", "buffers", "offchip"),
    "opt4": ("coarse", "fine", "reuse", "buffers", "offchip"),
    "opt5": ("coarse", "fine", "reuse", "buffers", "offchip", "schedule"),
}


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------


class PassManager:
    """Ordered pass registry + execution engine.

    ``run(graph, options, out)`` executes every enabled pass in order,
    honouring invalidations, and returns a :class:`CompileDiagnostics`.
    """

    def __init__(self, passes: Sequence[Pass] | None = None, *,
                 census: bool = True):
        self.passes: list[Pass] = list(passes) if passes is not None else default_passes()
        # The before/after violation census costs two whole-graph scans per
        # pass (~25% of a large compile); census=False records -1 counts
        # for throughput-critical batch runs that never read diagnostics.
        self.census = census

    @classmethod
    def default(cls) -> "PassManager":
        return cls()

    # ---- registry --------------------------------------------------------
    def names(self) -> list[str]:
        return [p.name for p in self.passes]

    def get(self, name: str) -> Pass:
        for p in self.passes:
            if p.name == name:
                return p
        raise KeyError(f"no pass {name!r}; registered: {self.names()}")

    def register(self, p: Pass, *, before: str | None = None,
                 after: str | None = None, replace: bool = False) -> Pass:
        """Insert (or replace) a pass.  ``before``/``after`` anchor the
        position; default append."""
        if replace:
            self.passes[self.names().index(p.name)] = p
            return p
        if p.name in self.names():
            raise ValueError(f"pass {p.name!r} already registered")
        if before is not None:
            self.passes.insert(self.names().index(before), p)
        elif after is not None:
            self.passes.insert(self.names().index(after) + 1, p)
        else:
            self.passes.append(p)
        return p

    def active(self, options: Any) -> list[str]:
        """Pass names that would run for ``options`` (without invalidation
        re-runs)."""
        return [p.name for p in self.passes if p.enabled(options)]

    # ---- execution -------------------------------------------------------
    def _execute(self, p: Pass, graph: Any, options: Any, out: Any,
                 records: list[PassRecord], rerun: bool) -> None:
        budgets = getattr(options, "pass_budgets", None) or {}
        sec, mem_mb, viol = _budget_dims(budgets.get(p.name, 0.0))
        cb, fb = ((len(coarse_violations(graph)), len(fine_violations(graph)))
                  if self.census else (-1, -1))
        mem_delta = 0.0
        trace_mem = mem_mb > 0
        if trace_mem:
            was_tracing = tracemalloc.is_tracing()
            if not was_tracing:
                tracemalloc.start()
            tracemalloc.reset_peak()
            base, _ = tracemalloc.get_traced_memory()
        t0 = time.perf_counter()
        report = p.run(graph, options, out)
        dt = time.perf_counter() - t0
        if trace_mem:
            _, peak = tracemalloc.get_traced_memory()
            mem_delta = max(0.0, (peak - base) / 1e6)
            if not was_tracing:
                tracemalloc.stop()
        with _COUNTS_LOCK:
            PASS_RUN_COUNTS[p.name] += 1
        ca, fa = ((len(coarse_violations(graph)), len(fine_violations(graph)))
                  if self.census else (-1, -1))
        if p.result_attr is not None and out is not None:
            prev = getattr(out, p.result_attr, None)
            if rerun and prev is not None and hasattr(prev, "merge"):
                prev.merge(report)
            else:
                setattr(out, p.result_attr, report)
        summary = report.summary() if hasattr(report, "summary") else ""
        records.append(PassRecord(p.name, dt, cb, ca, fb, fa,
                                  rerun=rerun, summary=summary,
                                  budget=sec, mem_budget_mb=mem_mb,
                                  mem_delta_mb=mem_delta,
                                  violation_budget=viol))

    def run(self, graph: Any, options: Any, out: Any = None) -> CompileDiagnostics:
        t0 = time.perf_counter()
        records: list[PassRecord] = []
        ran: list[str] = []
        for p in self.passes:
            if not p.enabled(options):
                continue
            self._execute(p, graph, options, out, records, rerun=False)
            ran.append(p.name)
            for stale in p.invalidates:
                if stale == p.name or stale not in ran:
                    continue
                q = self.get(stale)
                if q.enabled(options):
                    self._execute(q, graph, options, out, records, rerun=True)
        return CompileDiagnostics(graph=getattr(graph, "name", "?"),
                                  records=records,
                                  total_seconds=time.perf_counter() - t0)


__all__ = [
    "ABLATION_PRESETS", "DEFAULT_PASS_BUDGETS", "CompileDiagnostics", "Pass",
    "PassManager", "PassRecord", "PASS_RUN_COUNTS", "default_passes",
]
