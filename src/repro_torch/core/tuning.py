"""The tuning database routed kernels are decided by.

The routing gate (:mod:`repro_torch.core.routing`) decides
routed-vs-generic from *predicted* cycles unless a :class:`TuningDB`
holds a measured verdict for the chain.

Database entries are keyed on ``(chain structural signature, backend,
hw name)``: the signature hashes the chain's op kinds, attrs, and operand
shapes/dtypes (not buffer names), so a tuned decision transfers to any
design containing the same-shaped chain.  The routing layer consults the
database before the cost gate — measured beats predicted — and the
database digest enters the lowering memo key, so updating it never serves
a stale program.  Entries travel in artifact schema v1.2 (``tuning``
section) and in the disk compile cache (``tuning.json``).

This module replaces prediction with measurement on demand:
:func:`autotune_compiled` runs every structurally matched chain of a
compiled design both ways on the program's device — the routed kernel
against the generic task-by-task composition, each captured into a CUDA
graph on the card as a lowered program runs by default — and persists the
winner in a :class:`TuningDB`.

Everything except :func:`autotune_compiled` is importable without torch.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Iterable

from .graph import DataflowGraph, Task


def chain_signature(graph: DataflowGraph, tasks: list[Task]) -> str:
    """Structural identity of a matched chain: op kinds, spec attrs, and
    operand shapes/dtypes in chain order.  Buffer names are excluded —
    equal signatures mean the same-shaped computation."""
    import hashlib

    import numpy as np

    def _sig(b):
        # np.dtype canonicalizes: a live graph holds the numpy scalar
        # *class*, an artifact-restored one the dtype's string name.
        return (tuple(graph.buffers[b].shape),
                str(np.dtype(graph.buffers[b].dtype)))

    parts = []
    for t in tasks:
        if t.spec is None:
            parts.append((t.op,))
            continue
        ins = tuple(_sig(b) for b in t.spec.ins)
        outs = tuple(_sig(b) for b in t.spec.outs)
        attrs = tuple(sorted((k, repr(v)) for k, v in t.spec.attrs.items()))
        parts.append((t.op, t.spec.kind, attrs, ins, outs))
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


@dataclass
class TuningRecord:
    """One measured routing decision: for this chain signature on this
    backend/hardware, ``choice`` won at ``tile`` (``None`` = the kernel's
    default blocking, or the generic path when choice is ``xla-fused``)."""

    signature: str
    backend: str
    hw: str
    pattern: str
    choice: str                       # "pallas" | "xla-fused"
    tile: dict | None = None
    routed_ms: float = 0.0
    generic_ms: float = 0.0
    workload: str = ""
    tasks: list[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.signature}:{self.backend}:{self.hw}"

    @property
    def speedup(self) -> float:
        """Measured generic/routed ratio (>1 means the kernel won)."""
        return self.generic_ms / max(self.routed_ms, 1e-9)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: dict) -> "TuningRecord":
        return cls(signature=str(doc["signature"]),
                   backend=str(doc["backend"]), hw=str(doc["hw"]),
                   pattern=str(doc.get("pattern", "?")),
                   choice=str(doc.get("choice", "xla-fused")),
                   tile=doc.get("tile"),
                   routed_ms=float(doc.get("routed_ms", 0.0)),
                   generic_ms=float(doc.get("generic_ms", 0.0)),
                   workload=str(doc.get("workload", "")),
                   tasks=[str(t) for t in doc.get("tasks", ())])


class TuningDB:
    """Keyed store of :class:`TuningRecord`\\ s with a change-tracking
    digest (the lowering memo key ingredient)."""

    def __init__(self, records: Iterable[TuningRecord] = ()):
        self.entries: dict[str, TuningRecord] = {}
        self._digest: str | None = None
        for r in records:
            self.entries[r.key] = r

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, signature: str, backend: str,
               hw: str) -> TuningRecord | None:
        return self.entries.get(f"{signature}:{backend}:{hw}")

    def update(self, record: TuningRecord) -> None:
        self.entries[record.key] = record
        self._digest = None

    def merge(self, records: Iterable[TuningRecord]) -> int:
        n = 0
        for r in records:
            self.entries[r.key] = r
            n += 1
        if n:
            self._digest = None
        return n

    def digest(self) -> str:
        if self._digest is None:
            import hashlib
            canon = sorted((k, repr(sorted(asdict(r).items())))
                           for k, r in self.entries.items())
            self._digest = hashlib.sha256(
                repr(canon).encode()).hexdigest()[:16]
        return self._digest

    # ---- JSON persistence (also the artifact v1.2 `tuning` payload) ------
    def to_dict(self) -> dict:
        return {"entries": [self.entries[k].to_dict()
                            for k in sorted(self.entries)]}

    @classmethod
    def from_dict(cls, doc: dict) -> "TuningDB":
        return cls(TuningRecord.from_dict(e)
                   for e in (doc or {}).get("entries", ()))

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(
            json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str | Path) -> "TuningDB":
        return cls.from_dict(json.loads(Path(path).read_text()))


_DEFAULT_DB: TuningDB | None = None


def default_tuning_db() -> TuningDB:
    """The process-wide database routing consults.  Seeded once from the
    ``CODO_TUNING_DB`` JSON when that is set and readable; use
    :func:`reset_default_tuning_db` to re-read it."""
    global _DEFAULT_DB
    if _DEFAULT_DB is None:
        _DEFAULT_DB = TuningDB()
        path = os.environ.get("CODO_TUNING_DB", "").strip()
        if path:
            try:
                _DEFAULT_DB = TuningDB.load(path)
            except (OSError, ValueError, KeyError):
                pass
    return _DEFAULT_DB


def reset_default_tuning_db() -> None:
    global _DEFAULT_DB
    _DEFAULT_DB = None


# --------------------------------------------------------------------------
# The measured sweep (torch only from here down)
# --------------------------------------------------------------------------


def _random_env(graph: DataflowGraph, device, seed: int = 0) -> dict[str, Any]:
    """Random input/weight tensors on ``device`` straight from the buffer
    table — no model-builder dependency, so any compiled design can
    autotune.  Standard normals, as the reference draws them: a
    recurrence's gates leave (0, 1), which times the same work."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return {b.name: torch.as_tensor(
                rng.standard_normal(b.shape).astype(b.dtype), device=device)
            for b in graph.buffers.values()
            if b.kind in ("input", "weight")}


def _best_of(fns: list, env: dict, block, warmup: int,
             repeats: int) -> list[float]:
    """Best-of-N wall ms per callable (host time included: what a caller
    pays), reps interleaved round-robin so machine drift hits every
    candidate equally."""
    for _ in range(max(warmup, 1)):
        for fn in fns:
            fn(env)
            block()
    best = [float("inf")] * len(fns)
    for rep in range(max(repeats, 1)):
        order = range(len(fns)) if rep % 2 == 0 else range(len(fns) - 1, -1, -1)
        for i in order:
            t0 = time.perf_counter()
            fns[i](env)
            block()
            best[i] = min(best[i], time.perf_counter() - t0)
    return [b * 1e3 for b in best]


def autotune_compiled(compiled, *, device=None, db: TuningDB | None = None,
                      repeats: int = 5, warmup: int = 2, seed: int = 0,
                      save_path: str | Path | None = None,
                      ) -> list[TuningRecord]:
    """Measure every structurally matched chain of ``compiled`` routed vs
    generic on ``device`` and record the winners in ``db`` (the process
    default when ``None``), keyed for the device's routing backend.
    ``device`` resolves as every entry point's does
    (:func:`repro_torch.api.resolve_device`): the card when ``None``, and
    then one must be present; the CPU only when the caller asks for it.

    Matching is gate-free — the whole point is to replace the predictor's
    verdict with a measurement — and honors only the hard
    ``CODO_DISABLE_PALLAS`` switch.  The port's patterns declare no tile
    candidates (each CUDA wrapper picks its own blocking), so every chain
    has one routed candidate and ``tile=None``.  Returns the new records
    (also merged into ``db``; saved to ``save_path`` JSON when given).
    """
    import torch

    from repro_torch.api import resolve_device

    from . import routing
    from .capture import CapturedProgram
    from .costmodel import routing_backend
    from .lowering import FusionGroup

    device = resolve_device(device)
    routing.ensure_kernel_patterns()
    if db is None:
        db = default_tuning_db()
    graph = compiled.graph
    impl = compiled.buffer_plan.impl if compiled.buffer_plan else {}
    backend = routing_backend(device)
    hw_name = compiled.options.hw.name

    # Full buffer scope, produced task by task, to slice chain inputs from.
    scope = dict(_random_env(graph, device, seed))
    for t in graph.toposort():
        scope.update(t.fn(scope))

    if device.type == "cuda":
        def block():
            torch.cuda.synchronize(device)
    else:
        def block():
            pass

    records: list[TuningRecord] = []
    for gid, names in enumerate(routing.fifo_groups(graph, impl)):
        if len(names) < 2 or routing.pallas_disabled():
            continue
        group_view = FusionGroup(gid, list(names),
                                 tuple(graph.task(n).op for n in names))
        for pat, tasks in routing.match_group(graph, names, impl):
            interior = {t.writes[0].buffer for t in tasks[:-1]}
            ext = sorted({a.buffer for t in tasks for a in t.reads
                          if a.buffer not in interior})
            env = {b: scope[b] for b in ext}
            out_buf = tasks[-1].writes[0].buffer
            step = pat.factory(graph, group_view, tasks)
            if step is None:
                continue
            # Both ways as a lowered program runs them by default
            # (jit=True): the chain's task fns composed as the lowering
            # runs an unrouted group, and the kernel step, each captured
            # into a CUDA graph on the card (the reference times
            # jax.jit(generic)); eagerly on the CPU.
            fns = [CapturedProgram([(t.name, t.fn) for t in tasks],
                                   [out_buf]),
                   CapturedProgram([(tasks[-1].name, step)], [out_buf])]
            try:
                generic_ms, routed_ms = _best_of(fns, env, block, warmup,
                                                 repeats)
            finally:
                for fn in fns:
                    fn.release()
            choice = ("pallas" if routed_ms <= generic_ms
                      else routing.XLA_FUSED)
            rec = TuningRecord(
                signature=chain_signature(graph, tasks), backend=backend,
                hw=hw_name, pattern=pat.name, choice=choice, tile=None,
                routed_ms=round(routed_ms, 4),
                generic_ms=round(generic_ms, 4), workload=graph.name,
                tasks=[t.name for t in tasks])
            db.update(rec)
            records.append(rec)
    if save_path is not None:
        db.save(save_path)
    return records


__all__ = ["TuningDB", "TuningRecord", "autotune_compiled", "chain_signature",
           "default_tuning_db", "reset_default_tuning_db"]
