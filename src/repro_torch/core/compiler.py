"""codo_opt — the end-to-end compilation pipeline (paper Fig. 3).

Pass order (deeply co-optimizing, matching §III):

  1. coarse-grained violation elimination        (coarse.py)
  2. fine-grained violation elimination          (fine.py)
  3. reuse-buffer generation (+ re-run 1&2)      (reuse.py)
  4. communication-buffer determination          (buffers.py)
  5. off-chip transfer management                (offchip.py)
  6. automated dataflow scheduling + inter-task  (schedule.py)

The pipeline is driven by :class:`repro_torch.core.passes.PassManager`:
each pass is a named registry entry with declared invalidations, and every
run emits a :class:`~repro_torch.core.passes.CompileDiagnostics` (per-pass
wall time + before/after violation census).
``CodoOptions.preset("opt1").."opt5"`` reconstruct the Table VII ablations
from :data:`ABLATION_PRESETS`.

Results are memoized in a content-addressed :class:`CompileCache` keyed by
the graph's structural hash + the options.  The pass pipeline is plain
Python shared with the JAX reference line for line; the reference's batch
grid and CLI are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from dataclasses import dataclass

from .buffers import BufferPlan
from .cache import CompileCache
from .coarse import CoarseReport
from .costmodel import V5E, GraphCost, HwParams, graph_latency, sequential_latency
from .fine import FineReport
from .graph import DataflowGraph
from .offchip import TransferPlan
from .passes import ABLATION_PRESETS, CompileDiagnostics, PassManager
from .patterns import coarse_violations
from .reuse import ReuseReport
from .schedule import ScheduleReport


@dataclass
class CodoOptions:
    """User-facing knobs of ``codo-opt`` (§III: "users can optionally adjust
    input parameters like maximum parallelism and tiling factors")."""

    coarse: bool = True
    fine: bool = True
    communication: bool = True      # reuse buffers + buffer determination + offchip
    scheduling: bool = True
    enable_up: bool = True
    enable_dp: bool = True
    budget_units: int | None = None
    max_degree: int = 4096
    balance_n: float = 2.0
    hbm_channels: int = 8
    hw: HwParams = V5E
    # Per-pass budgets ({} / None = unenforced).  A bare number is a
    # wall-time budget in seconds (the original shape); a dict value may
    # set any of {"seconds": float, "mem_mb": float, "violations": int} —
    # peak python-allocation delta during the pass (measured via
    # tracemalloc only when requested) and a cap on the coarse+fine
    # violations *left* after the pass.  A pass exceeding any dimension
    # marks its PassRecord over_budget; see enforce_pass_budgets() and the
    # CLI --enforce-budgets/--strict flags.  Enforcement-only: budgets
    # never change the compiled design, so they are excluded from
    # cache_key().
    pass_budgets: dict[str, float | dict] | None = None

    def __post_init__(self):
        if self.pass_budgets is not None:
            norm = {}
            for k, v in sorted(dict(self.pass_budgets).items()):
                if isinstance(v, dict):
                    bad = set(v) - {"seconds", "mem_mb", "violations"}
                    if bad:
                        raise ValueError(
                            f"pass_budgets[{k!r}]: unknown dimension(s) "
                            f"{sorted(bad)}; allowed: seconds, mem_mb, "
                            f"violations")
                    norm[str(k)] = {dk: (int(dv) if dk == "violations"
                                         else float(dv))
                                    for dk, dv in sorted(v.items())}
                else:
                    norm[str(k)] = float(v)
            self.pass_budgets = norm

    # ---- pass-set presets (Table VII as data) -----------------------------
    def pass_set(self) -> tuple[str, ...]:
        """Names of the default-pipeline passes these options enable."""
        return tuple(PassManager.default().active(self))

    @classmethod
    def from_passes(cls, names, **overrides) -> "CodoOptions":
        """Options whose flags enable exactly the given pass names (plus
        ``buffers``, which always runs).  Raises when the set is not
        expressible — ``reuse`` and ``offchip`` share the single
        ``communication`` flag, so one without the other is rejected
        rather than silently widened."""
        names = set(names)
        known = {p.name for p in PassManager.default().passes}
        unknown = names - known
        if unknown:
            raise KeyError(f"unknown passes {sorted(unknown)}; known: {sorted(known)}")
        opts = cls(
            coarse="coarse" in names,
            fine="fine" in names,
            communication=bool(names & {"reuse", "offchip"}),
            scheduling="schedule" in names,
            **overrides,
        )
        got = set(opts.pass_set())
        want = names | {"buffers"}
        if got != want:
            raise ValueError(
                f"pass set {sorted(want)} is not expressible as option flags "
                f"(would enable {sorted(got)}); reuse/offchip are gated "
                f"together by `communication`")
        return opts

    @classmethod
    def preset(cls, name: str, **overrides) -> "CodoOptions":
        """Table VII ablation preset: ``preset("opt3", budget_units=512)``."""
        if name not in ABLATION_PRESETS:
            raise KeyError(f"unknown preset {name!r}; known: {sorted(ABLATION_PRESETS)}")
        return cls.from_passes(ABLATION_PRESETS[name], **overrides)

    @staticmethod
    def opt1() -> "CodoOptions":
        return CodoOptions.preset("opt1")

    @staticmethod
    def opt2() -> "CodoOptions":
        return CodoOptions.preset("opt2")

    @staticmethod
    def opt3() -> "CodoOptions":
        return CodoOptions.preset("opt3")

    @staticmethod
    def opt4() -> "CodoOptions":
        return CodoOptions.preset("opt4")

    @staticmethod
    def opt5() -> "CodoOptions":
        return CodoOptions.preset("opt5")

    # ---- content addressing ------------------------------------------------
    def cache_key(self) -> str:
        """Stable hash of every option field that affects the compiled
        design (HwParams is a frozen dataclass, so its repr is canonical).
        ``pass_budgets`` only gates *reporting*, so two compiles differing
        only in budgets share a cache entry."""
        sig = tuple((f.name, repr(getattr(self, f.name)))
                    for f in dataclasses.fields(self)
                    if f.name != "pass_budgets")
        return hashlib.sha256(repr(sig).encode()).hexdigest()

    # ---- JSON serialization (docs/artifact_format.md `options`) -----------
    def to_dict(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name != "hw"}
        out["hw"] = dataclasses.asdict(self.hw)
        return out

    @classmethod
    def from_dict(cls, doc: dict) -> "CodoOptions":
        doc = dict(doc)
        hw = doc.pop("hw", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise KeyError(f"unknown CodoOptions fields {sorted(unknown)}; "
                           f"known: {sorted(known)}")
        return cls(**doc, hw=HwParams(**hw) if hw is not None else V5E)


@dataclass
class CompiledDataflow:
    graph: DataflowGraph
    options: CodoOptions
    coarse_report: CoarseReport | None = None
    fine_report: FineReport | None = None
    reuse_report: ReuseReport | None = None
    buffer_plan: BufferPlan | None = None
    transfer_plan: TransferPlan | None = None
    schedule_report: ScheduleReport | None = None
    baseline: GraphCost | None = None          # sequential, degree 1
    final: GraphCost | None = None
    compile_seconds: float = 0.0
    diagnostics: CompileDiagnostics | None = None

    @property
    def speedup(self) -> float:
        if not self.baseline or not self.final or self.final.total_cycles == 0:
            return 1.0
        return self.baseline.total_cycles / self.final.total_cycles

    @property
    def fifo_fraction(self) -> float:
        return self.buffer_plan.fifo_fraction() if self.buffer_plan else 0.0

    @property
    def cache_hit(self) -> bool:
        return bool(self.diagnostics and self.diagnostics.cache_hit)

    def report(self) -> str:
        lines = [f"== codo_opt({self.graph.name}) =="]
        for r in (self.coarse_report, self.fine_report, self.reuse_report,
                  self.buffer_plan, self.transfer_plan, self.schedule_report):
            if r is not None:
                lines.append("  " + r.summary())
        if self.baseline and self.final:
            lines.append(f"  baseline {self.baseline.total_cycles:,.0f} cyc -> "
                         f"final {self.final.total_cycles:,.0f} cyc "
                         f"({self.speedup:.1f}x, {self.fifo_fraction:.0%} FIFO)")
        if self.diagnostics is not None:
            lines.append("  " + self.diagnostics.summary())
        lines.append(f"  compile time {self.compile_seconds*1e3:.1f} ms")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

_DEFAULT_MANAGER: PassManager | None = None
_DEFAULT_CACHE: CompileCache | None = None
_UNSET = object()


def default_manager() -> PassManager:
    global _DEFAULT_MANAGER
    if _DEFAULT_MANAGER is None:
        _DEFAULT_MANAGER = PassManager.default()
    return _DEFAULT_MANAGER


def default_cache() -> CompileCache:
    """Process-wide cache; ``CODO_CACHE_SIZE``/``CODO_CACHE_DIR`` configure
    the LRU size and the optional disk tier."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = CompileCache(
            maxsize=int(os.environ.get("CODO_CACHE_SIZE", "256")),
            disk_dir=os.environ.get("CODO_CACHE_DIR") or None)
    return _DEFAULT_CACHE


def codo_opt(graph: DataflowGraph, options: CodoOptions | None = None, *,
             cache: CompileCache | None = _UNSET,
             manager: PassManager | None = None) -> CompiledDataflow:
    """Compile ``graph`` under ``options`` through the pass pipeline.

    ``cache=None`` disables memoization for this call; any other
    :class:`CompileCache` overrides the process default.
    """
    t0 = time.perf_counter()
    opts = options or CodoOptions()
    cache = default_cache() if cache is _UNSET else cache

    key = ""
    if cache is not None:
        key = cache.key(graph, opts)
        hit = cache.get(key)
        if hit is not None:
            hit.compile_seconds = time.perf_counter() - t0
            return hit

    g = graph.copy()
    g.validate()
    out = CompiledDataflow(g, opts)
    out.baseline = sequential_latency(g, opts.hw)
    diag = (manager or default_manager()).run(g, opts, out)

    # A design with surviving coarse violations cannot enter a dataflow
    # region at all — it executes sequentially (the Opt1 lesson of Fig. 10).
    sequential = bool(coarse_violations(g))
    out.final = graph_latency(g, opts.hw, out.buffer_plan, sequential=sequential)
    out.compile_seconds = time.perf_counter() - t0
    diag.total_seconds = out.compile_seconds
    diag.cache_key = key
    out.diagnostics = diag
    if cache is not None:
        cache.put(key, out)
    return out


__all__ = ["CodoOptions", "CompiledDataflow", "codo_opt", "default_cache",
           "default_manager"]
