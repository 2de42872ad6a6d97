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
Python shared with the JAX reference line for line.

Batch mode compiles many (config, preset) cells concurrently — with worker
*processes* by default on the CLI (tasks are declarative OpSpec records,
so jobs and results pickle across the pool; workers share the disk cache
tier and are spawned, never forked: torch and CUDA are not fork-safe), or
threads via ``codo_opt_batch(..., executor="thread")``:

    python -m repro_torch.core.compiler --all --ablations --jobs 4
    python -m repro_torch.core.compiler --configs gpt2-medium,mamba2-780m --opts opt5

``--export DIR`` writes every grid cell as a versioned JSON artifact
(docs/artifact_format.md) that either package imports, and
``--import-artifact PATH`` reconstructs an executable design from one
written by either package.  ``--profile`` prints the per-pass timing
table and the kernel-routing table; ``--autotune`` measures every matched
chain on ``--device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import multiprocessing
import os
import pickle
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass

from .buffers import BufferPlan
from .cache import CompileCache, _clone
from .coarse import CoarseReport
from .costmodel import V5E, GraphCost, HwParams, graph_latency, sequential_latency
from .fine import FineReport
from .graph import DataflowGraph
from .offchip import TransferPlan
from .passes import (ABLATION_PRESETS, DEFAULT_PASS_BUDGETS,
                     CompileDiagnostics, PassManager)
from .patterns import coarse_violations, fine_violations
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


class PassBudgetError(RuntimeError):
    """Raised by :func:`enforce_pass_budgets` in strict mode when any pass
    exceeded a budget dimension (wall time, memory delta, or the
    remaining-violation cap)."""


def enforce_pass_budgets(diagnostics, *, strict: bool = False) -> list[str]:
    """Collect per-pass budget violations across many
    :class:`CompileDiagnostics` (cache hits carry no pass records and are
    skipped).  Non-strict: emit one :class:`RuntimeWarning` per violation
    and return them; strict: raise :class:`PassBudgetError` listing all.
    """
    import warnings
    violations: list[str] = []
    for d in diagnostics:
        if d is None or d.cache_hit:
            continue
        violations.extend(d.budget_violations())
    if violations and strict:
        raise PassBudgetError(
            f"{len(violations)} pass-budget violation(s):\n  "
            + "\n  ".join(violations))
    for v in violations:
        warnings.warn(f"pass budget exceeded: {v}", RuntimeWarning,
                      stacklevel=2)
    return violations


def verify_violation_free(compiled: CompiledDataflow) -> list[str]:
    """Post-compilation invariant check (tests + CI): every FIFO edge must
    be violation-free; ping-pong edges may keep violations by design."""
    problems = []
    g = compiled.graph
    for v in coarse_violations(g):
        problems.append(f"coarse:{v.kind}:{v.buffer}")
    impl = compiled.buffer_plan.impl if compiled.buffer_plan else {}
    for v in fine_violations(g):
        if impl.get(v.buffer) == "fifo":
            problems.append(f"fine-on-fifo:{v.kind}:{v.buffer}")
    return problems


# --------------------------------------------------------------------------
# Batch driver
# --------------------------------------------------------------------------


@dataclass
class BatchJob:
    """One cell of the batch grid.  ``build`` returns a fresh graph (called
    inside the worker so graph construction parallelizes too)."""

    config: str
    preset: str
    build: "object"           # () -> DataflowGraph
    options: CodoOptions


@dataclass
class BatchResult:
    config: str
    preset: str
    compiled: CompiledDataflow | None = None
    error: str = ""
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return self.compiled is not None

    @property
    def cache_hit(self) -> bool:
        return bool(self.compiled and self.compiled.cache_hit)

    def derived(self) -> str:
        """The per-cell metrics string of the CLI CSV."""
        if not self.ok:
            return self.error
        c = self.compiled
        return (f"fifo={c.fifo_fraction:.2f};cycles={c.final.total_cycles:.4g};"
                f"compile_ms={c.compile_seconds * 1e3:.2f};"
                f"cached={int(self.cache_hit)}")

    def csv(self) -> str:
        if not self.ok:
            return f"{self.config},{self.preset},error,{self.error}"
        return f"{self.config},{self.preset},{self.compiled.speedup:.4g},{self.derived()}"


def ablation_jobs(workloads: dict, presets=None, **option_overrides) -> list[BatchJob]:
    """(config × preset) grid over ``workloads`` (name -> graph factory)."""
    presets = list(presets) if presets is not None else list(ABLATION_PRESETS)
    jobs = []
    for cname, build in workloads.items():
        for pname in presets:
            jobs.append(BatchJob(cname, pname, build,
                                 CodoOptions.preset(pname, **option_overrides)))
    return jobs


def _run_job(job: BatchJob, cache, manager) -> BatchResult:
    """One cell: build the graph (inside the worker, so construction
    parallelizes too) and compile it."""
    t0 = time.perf_counter()
    res = BatchResult(job.config, job.preset)
    try:
        g = job.build() if callable(job.build) else job.build
        res.compiled = codo_opt(g, job.options, cache=cache, manager=manager)
    except Exception as e:  # keep the grid going; report per-cell
        res.error = f"{type(e).__name__}: {e}"
    res.seconds = time.perf_counter() - t0
    return res


# ---- process-pool plumbing -------------------------------------------------
# Each worker owns a private memory-tier cache; all workers share the disk
# tier (if any), so a warm grid is served from disk in every process.

_WORKER_CACHE: CompileCache | None = None


def _init_batch_worker(disk_dir: str | None, use_cache: bool,
                       json_mirror: bool = False) -> None:
    global _WORKER_CACHE
    _WORKER_CACHE = (CompileCache(disk_dir=disk_dir, json_mirror=json_mirror)
                     if use_cache else None)


def _run_job_in_worker(job: BatchJob) -> BatchResult:
    res = _run_job(job, _WORKER_CACHE, None)
    if res.compiled is not None:
        # Results cross the pipe back to the parent: closure overrides (if
        # any survived a closure-built job) cannot; specs can.
        res.compiled = _clone(res.compiled, strip_closures=True)
    return res


def codo_opt_batch(jobs, *, max_workers: int | None = None,
                   cache: CompileCache | None = _UNSET,
                   manager: PassManager | None = None,
                   executor: str = "thread") -> list[BatchResult]:
    """Compile every :class:`BatchJob` concurrently.

    ``executor="thread"`` (default) shares one in-process cache across a
    thread pool — the pipeline is pure Python, so threads mostly serialize
    on the GIL but tolerate arbitrary (closure) jobs.  ``executor="process"``
    fans out over a :class:`ProcessPoolExecutor` of *spawned* workers for
    real parallelism: jobs must pickle (declarative graphs / module-level
    builders — see :func:`batch_workloads`), a custom ``manager`` cannot
    ship, and workers share only the disk cache tier of ``cache``.
    """
    jobs = list(jobs)
    cache = default_cache() if cache is _UNSET else cache
    workers = max_workers or min(32, (os.cpu_count() or 4))
    if executor not in ("thread", "process"):
        raise ValueError(f"unknown executor {executor!r}: thread|process")

    if executor == "process" and workers > 1 and len(jobs) > 1:
        if manager is not None:
            raise ValueError("executor='process' cannot ship a custom "
                             "PassManager; workers use the default pipeline")
        try:
            pickle.dumps(jobs)
        except Exception as e:
            raise ValueError(
                "executor='process' requires picklable jobs (declarative "
                "specs + module-level graph builders, e.g. batch_workloads); "
                f"use executor='thread' for closure jobs ({e})") from e
        disk_dir = (str(cache.disk_dir)
                    if cache is not None and cache.disk_dir else None)
        with ProcessPoolExecutor(
                max_workers=min(workers, len(jobs)),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_batch_worker,
                initargs=(disk_dir, cache is not None,
                          bool(cache is not None and cache.json_mirror))) as pool:
            return list(pool.map(_run_job_in_worker, jobs))

    if workers <= 1 or len(jobs) <= 1:
        return [_run_job(j, cache, manager) for j in jobs]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda j: _run_job(j, cache, manager), jobs))


def _resnet18_workload():
    from repro_torch.models.dataflow_models import resnet18
    return resnet18(32)


def _gpt2_block_workload(seq: int = 128):
    from repro_torch.models.dataflow_models import gpt2_block
    return gpt2_block(S=seq)


def _arch_workload(cfg, seq: int):
    from repro_torch.models.dataflow_models import arch_block_graph
    return arch_block_graph(cfg, S=seq)


def batch_workloads(seq: int = 64):
    """The batch-compile model grid: every arch config in
    ``repro_torch/configs/`` as a representative block graph, plus the
    paper's flagship ResNet-18 CNN and the Fig. 9 GPT-2 block.  Factories
    are ``functools.partial`` of module-level builders — picklable, so the
    grid ships to spawned worker processes."""
    from repro_torch.configs import CONFIGS

    workloads = {name: functools.partial(_arch_workload, cfg, seq)
                 for name, cfg in sorted(CONFIGS.items())}
    workloads["resnet18"] = _resnet18_workload
    workloads["gpt2_block"] = functools.partial(_gpt2_block_workload, seq)
    return workloads


def kernel_workloads():
    """The Table II kernels as batch-grid factories: module-level traced
    builders, so jobs built from them pickle into the worker processes
    like the config grid does."""
    from repro_torch.models.dataflow_models import KERNEL_BENCHES

    return dict(KERNEL_BENCHES)


# --------------------------------------------------------------------------
# Reports (CLI --profile, the grid)
# --------------------------------------------------------------------------


def profile_table(diagnostics) -> str:
    """Aggregate per-pass timing across many :class:`CompileDiagnostics`
    into the ``--profile`` table: calls, total/mean wall time, and share
    of all pass time.  Cache hits carry no pass records and are skipped."""
    totals: dict[str, float] = {}
    calls: dict[str, int] = {}
    compiles = 0
    for d in diagnostics:
        if d is None or d.cache_hit or not d.records:
            continue
        compiles += 1
        for r in d.records:
            totals[r.name] = totals.get(r.name, 0.0) + r.seconds
            calls[r.name] = calls.get(r.name, 0) + 1
    if not totals:
        return "profile: no pass records (every compile was a cache hit)"
    grand = sum(totals.values())
    lines = [f"-- pass profile: {compiles} compiles, "
             f"{grand * 1e3:.1f} ms in passes --",
             f"  {'pass':<10s} {'calls':>5s} {'total ms':>10s} "
             f"{'mean ms':>9s} {'share':>6s}"]
    for name, tot in sorted(totals.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<10s} {calls[name]:>5d} {tot * 1e3:>10.2f} "
                     f"{tot / calls[name] * 1e3:>9.2f} {tot / grand:>6.1%}")
    return "\n".join(lines)


def routing_table(results) -> str:
    """The ``--profile`` kernel-routing table: per grid cell, how many
    fusion groups the cost gate routes to kernels, and per matched chain
    the predicted speedup vs the measured one (when the tuning database
    has an entry).  Derived structurally (:func:`repro_torch.core.routing.
    route_plan`): no lowering, no execution."""
    from .routing import XLA_FUSED, route_plan
    lines = ["-- kernel routing (cost-gated; predicted vs measured) --"]
    pattern_counts: dict[str, int] = {}
    total = routed = 0

    def _chain_line(c: dict, verdict: str) -> str:
        pred = (c["predicted_generic_cycles"]
                / max(c["predicted_routed_cycles"], 1e-9))
        measured = c.get("measured_speedup")
        meas = f"{measured:.3f}x" if measured is not None else "--"
        return (f"    {c['kernel']:<24s} {verdict:<16s} "
                f"pred={pred:.3f}x meas={meas} "
                f"({'+'.join(c['tasks'])})")

    for r in results:
        if not r.ok:
            continue
        impl = r.compiled.buffer_plan.impl if r.compiled.buffer_plan else {}
        plan = route_plan(r.compiled.graph, impl)
        cell_routed = [p for p in plan if p["kernel"] != XLA_FUSED]
        total += len(plan)
        routed += len(cell_routed)
        for p in cell_routed:
            for route in p["routes"]:
                pattern_counts[route["kernel"]] = \
                    pattern_counts.get(route["kernel"], 0) + 1
        detail = (": " + ", ".join(sorted({p["kernel"] for p in cell_routed}))
                  if cell_routed else "")
        lines.append(f"  {r.config}/{r.preset}: {len(cell_routed)}/"
                     f"{len(plan)} groups pallas-routed{detail}")
        for p in plan:
            for c in p["routes"]:
                lines.append(_chain_line(c, c.get("decision", "?")))
            for c in p.get("rejected", ()):
                lines.append(_chain_line(c, c.get("decision", "?")))
    pats = (", ".join(f"{k} x{v}" for k, v in sorted(pattern_counts.items()))
            or "none")
    lines.append(f"  total: {routed}/{total} groups routed; patterns: {pats}")
    return "\n".join(lines)


def autotune_results(results, cache=None, *, repeats: int = 5,
                     warmup: int = 2, device=None) -> str:
    """The ``--autotune`` verb: measure routed-vs-generic for every
    compiled cell on ``device`` (the card when ``None``; see
    ``repro_torch.api.resolve_device``), persist the winners in the
    process tuning database (and the cache's disk tier when present), and
    return a per-chain report."""
    from repro_torch.api import resolve_device

    from .tuning import autotune_compiled, default_tuning_db
    device = resolve_device(device)
    lines = [f"-- autotune (measured routed-vs-generic per chain, on "
             f"{device}) --"]
    tuned = 0
    for r in results:
        if not r.ok:
            continue
        try:
            recs = autotune_compiled(r.compiled, device=device,
                                     repeats=repeats, warmup=warmup)
        except Exception as e:           # un-executable cells (stripped fns)
            lines.append(f"  {r.config}/{r.preset}: skipped ({e})")
            continue
        tuned += len(recs)
        for rec in recs:
            tile = f" tile={rec.tile}" if rec.tile else ""
            lines.append(
                f"  {r.config}/{r.preset} {rec.pattern:<24s} -> "
                f"{rec.choice:<9s} {rec.speedup:.3f}x "
                f"(routed={rec.routed_ms:.3f}ms generic={rec.generic_ms:.3f}"
                f"ms){tile}")
    db = default_tuning_db()
    where = ""
    if cache is not None and getattr(cache, "disk_dir", None):
        path = cache.save_tuning_db(db)
        where = f"; persisted to {path}"
    lines.append(f"  {tuned} chains measured; tuning DB has {len(db)} "
                 f"entries{where}")
    return "\n".join(lines)


def format_batch_grid(results) -> str:
    """Table VII-style text grid from :func:`codo_opt_batch` results: one
    row per config, one speedup column per preset.  Cached cells are
    marked ``*`` (their compile time is the lookup, not a pipeline run)."""
    presets = sorted({r.preset for r in results},
                     key=lambda p: list(ABLATION_PRESETS).index(p)
                     if p in ABLATION_PRESETS else 99)
    configs = sorted({r.config for r in results})
    by_cell = {(r.config, r.preset): r for r in results}

    w = max([len(c) for c in configs] + [8])
    head = f"{'config':<{w}s} " + " ".join(f"{p:>12s}" for p in presets) \
        + "   fifo   compile_ms"
    lines = [head, "-" * len(head)]
    for cname in configs:
        cells, fifo, ms = [], "", 0.0
        for p in presets:
            r = by_cell.get((cname, p))
            if r is None or not r.ok:
                cells.append(f"{'ERR':>12s}")
                continue
            mark = "*" if r.cache_hit else ""
            cells.append(f"{r.compiled.speedup:>11.1f}{mark or 'x'}")
            fifo = f"{r.compiled.fifo_fraction:.2f}"
            ms += r.compiled.compile_seconds * 1e3
        lines.append(f"{cname:<{w}s} " + " ".join(cells)
                     + f"   {fifo:>4s}   {ms:>9.1f}")
    lines.append("(speedup vs sequential baseline; '*' = compile-cache hit; "
                 "fifo from the last preset column; compile_ms = row total "
                 "across preset columns)")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI:  python -m repro_torch.core.compiler --all --ablations
# --------------------------------------------------------------------------


def _csv_grid(results) -> str:
    return "\n".join(["config,preset,speedup,derived"] + [r.csv() for r in results])


def _parse_pass_budgets(ap, spec: str) -> dict:
    """``--pass-budget PASS=SEC[:MEM_MB[:VIOL]][,...]`` over
    :data:`DEFAULT_PASS_BUDGETS`."""
    budgets = dict(DEFAULT_PASS_BUDGETS)
    for item in spec.split(","):
        if not item.strip():
            continue
        pname, _, val = item.partition("=")
        pname = pname.strip()
        if pname not in budgets or not val:
            ap.error(f"--pass-budget wants PASS=SEC[:MEM_MB[:VIOL]] "
                     f"with PASS in {sorted(budgets)}, got {item!r}")
        try:
            parts = val.split(":")
            if len(parts) > 3:
                raise ValueError("too many ':' dimensions")
            dims: dict[str, float | int] = {}
            if parts[0]:
                dims["seconds"] = float(parts[0])
            if len(parts) > 1 and parts[1]:
                dims["mem_mb"] = float(parts[1])
            if len(parts) > 2 and parts[2]:
                dims["violations"] = int(parts[2])
        except ValueError as e:
            ap.error(f"--pass-budget {item!r}: {e}")
        if not dims:
            ap.error(f"--pass-budget {item!r}: every dimension empty")
        budgets[pname] = (dims["seconds"]
                          if set(dims) == {"seconds"} else dims)
    return budgets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.compiler",
        description="Batch-compile the model-config grid through codo-opt "
                    "and print a Table VII-style ablation report.")
    ap.add_argument("--all", action="store_true",
                    help="compile every model config (default if --configs absent)")
    ap.add_argument("--configs", default="",
                    help="comma list of configs (see --list)")
    ap.add_argument("--ablations", action="store_true",
                    help="run the full opt1..opt5 grid (Table VII)")
    ap.add_argument("--opts", default="opt5",
                    help="comma list of presets when --ablations is not given")
    ap.add_argument("--jobs", type=int, default=0,
                    help="worker processes (0 = auto)")
    ap.add_argument("--executor", choices=("process", "thread"),
                    default="process",
                    help="batch executor: spawned worker processes "
                         "(default; real parallelism, shared disk cache) or "
                         "in-process threads")
    ap.add_argument("--seq", type=int, default=64,
                    help="sequence length for LM block graphs")
    ap.add_argument("--kernels", action="store_true",
                    help="add the Table II traced-kernel workloads to the "
                         "grid (module-level traced builders: they ship to "
                         "the --jobs worker processes like the configs do)")
    ap.add_argument("--budget", type=int, default=2048,
                    help="scheduler budget units")
    ap.add_argument("--pass-budget", default="",
                    metavar="PASS=SEC[:MEM_MB[:VIOL]][,...]",
                    help="per-pass budgets: wall seconds, optional peak "
                         "python-allocation delta in MB, optional cap on "
                         "violations left after the pass, e.g. "
                         "'schedule=0.5,reuse=0.2:64,fine=0.1:32:0'; an "
                         "empty dimension skips it ('fine=::0'); unlisted "
                         "passes keep the DEFAULT_PASS_BUDGETS entry")
    ap.add_argument("--enforce-budgets", action="store_true",
                    help="after the grid, warn about every pass execution "
                         "that exceeded its time budget")
    ap.add_argument("--strict", action="store_true",
                    help="with --enforce-budgets: exit non-zero on any "
                         "budget violation")
    ap.add_argument("--cache-dir", default=os.environ.get("CODO_CACHE_DIR", ".codo_cache"),
                    help="on-disk compile-cache directory ('' to keep memory-only)")
    ap.add_argument("--no-cache", action="store_true", help="disable caching")
    ap.add_argument("--clear-cache", action="store_true",
                    help="drop existing disk-cache entries first")
    ap.add_argument("--csv", default="", help="also write the grid to this CSV file")
    ap.add_argument("--list", action="store_true", help="list configs and exit")
    ap.add_argument("--profile", action="store_true",
                    help="print the per-pass timing table aggregated from "
                         "CompileDiagnostics and the kernel-routing table")
    ap.add_argument("--autotune", action="store_true",
                    help="after the grid, measure routed-vs-generic per "
                         "matched chain on --device, persist the winners in "
                         "the tuning database, and print the measured table")
    ap.add_argument("--device", default=None,
                    help="where --autotune measures: a torch device string "
                         "(default: the CUDA card; 'cpu' to ask for the CPU)")
    ap.add_argument("--export", default="", metavar="DIR",
                    help="export every compiled cell as a versioned JSON "
                         "artifact to DIR (docs/artifact_format.md)")
    ap.add_argument("--import-artifact", default="", metavar="PATH",
                    help="import one exported artifact (written by either "
                         "package), print its report, and exit (ignores the "
                         "grid options)")
    args = ap.parse_args(argv)

    if args.import_artifact:
        from .artifact import artifact_summary, import_artifact
        from .routing import ensure_kernel_patterns
        ensure_kernel_patterns()
        compiled = import_artifact(args.import_artifact)
        print(artifact_summary(args.import_artifact))
        print(compiled.report())
        if args.profile and compiled.diagnostics is not None:
            print(compiled.diagnostics.table())
        return 0

    workloads = batch_workloads(seq=args.seq)
    if args.kernels:
        workloads.update(kernel_workloads())
    if args.list:
        print("\n".join(sorted(workloads)))
        return 0
    if args.all and args.configs:
        ap.error("--all and --configs are mutually exclusive")
    if args.strict and not args.enforce_budgets:
        ap.error("--strict requires --enforce-budgets")
    if args.configs:
        names = [c.strip() for c in args.configs.split(",") if c.strip()]
        unknown = [n for n in names if n not in workloads]
        if unknown:
            ap.error(f"unknown configs {unknown}; known: {sorted(workloads)}")
        workloads = {n: workloads[n] for n in names}

    presets = (list(ABLATION_PRESETS) if args.ablations
               else [p.strip() for p in args.opts.split(",") if p.strip()])
    bad_presets = [p for p in presets if p not in ABLATION_PRESETS]
    if bad_presets:
        ap.error(f"unknown presets {bad_presets}; known: {sorted(ABLATION_PRESETS)}")
    if not presets:
        ap.error("no presets selected (use --ablations or --opts opt1,...)")

    if args.no_cache:
        cache = None
    else:
        cache = CompileCache(disk_dir=args.cache_dir or None)
        if args.clear_cache:
            cache.clear(disk=True)
        # Measured routing decisions persist next to the compiles.
        cache.load_tuning_db()

    budgets = None
    if args.pass_budget or args.enforce_budgets:
        budgets = _parse_pass_budgets(ap, args.pass_budget)

    if args.profile or args.export or args.autotune:
        from .routing import ensure_kernel_patterns
        ensure_kernel_patterns()    # routing verbs see the real registry
    jobs = ablation_jobs(workloads, presets, budget_units=args.budget,
                         pass_budgets=budgets)
    t0 = time.perf_counter()
    results = codo_opt_batch(jobs, max_workers=args.jobs or None, cache=cache,
                             executor=args.executor)
    wall = time.perf_counter() - t0
    print(format_batch_grid(results))

    hits = sum(1 for r in results if r.cache_hit)
    errors = [r for r in results if not r.ok]
    print(f"\n{len(results)} compilations ({len(workloads)} configs x "
          f"{len(presets)} presets) in {wall:.2f} s wall; "
          f"{hits} cache hits" + (f"; cache dir {args.cache_dir}" if cache and cache.disk_dir else ""))
    if cache is not None:
        if args.executor == "process":
            # Worker processes own the cache stats; the parent only sees
            # the per-cell hit flags aggregated above.
            print("cache: per-worker memory tiers"
                  + (f", shared disk tier at {cache.disk_dir}"
                     if cache.disk_dir else ""))
        else:
            print(cache.stats.summary())
    for r in errors:
        print(f"ERROR {r.config}/{r.preset}: {r.error}", file=sys.stderr)
    if args.autotune:
        print()
        print(autotune_results(results, cache, device=args.device))
    if args.profile:
        print()
        print(profile_table(r.compiled.diagnostics for r in results if r.ok))
        print()
        print(routing_table(results))
    if args.enforce_budgets:
        diags = [r.compiled.diagnostics for r in results if r.ok]
        checked = sum(1 for d in diags if d is not None and not d.cache_hit)
        try:
            violations = enforce_pass_budgets(diags, strict=args.strict)
        except PassBudgetError as e:
            print(f"STRICT: {e}", file=sys.stderr)
            return 1
        if violations:
            print(f"{len(violations)} pass-budget violation(s) "
                  f"(non-strict: warnings only)", file=sys.stderr)
        elif checked:
            print(f"pass budgets: all passes within budget "
                  f"({checked} compiles checked)")
        else:
            print("pass budgets: nothing to check (every compile was a "
                  "cache hit — no pass records)")
    if args.export:
        from .artifact import export_artifact
        os.makedirs(args.export, exist_ok=True)
        exported = 0
        for r in results:
            if not r.ok:
                continue
            try:
                export_artifact(r.compiled, os.path.join(
                    args.export, f"{r.config}-{r.preset}.json"))
                exported += 1
            except Exception as e:
                print(f"EXPORT FAIL {r.config}/{r.preset}: {e}",
                      file=sys.stderr)
        print(f"exported {exported}/{len(results)} artifacts to {args.export}")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(_csv_grid(results) + "\n")
    return 1 if errors else 0


__all__ = ["BatchJob", "BatchResult", "CodoOptions", "CompiledDataflow",
           "PassBudgetError", "ablation_jobs", "autotune_results",
           "batch_workloads", "codo_opt", "codo_opt_batch", "default_cache",
           "default_manager", "enforce_pass_budgets", "format_batch_grid",
           "kernel_workloads", "main", "profile_table", "routing_table",
           "verify_violation_free"]


if __name__ == "__main__":
    raise SystemExit(main())
