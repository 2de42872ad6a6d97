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

The measured sweep (``autotune_compiled``) is not ported yet; the port
carries the database and the chain signature the routing gate reads.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Iterable

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


__all__ = ["TuningDB", "TuningRecord", "chain_signature", "default_tuning_db",
           "reset_default_tuning_db"]
