"""Content-addressed compile cache for ``codo_opt``.

The key is ``DataflowGraph.structural_hash()`` (everything the passes read,
minus numeric closures) combined with ``CodoOptions.cache_key()``, so two
independent builds of the same model under the same options hit the same
entry — including across processes when a disk directory is configured.

Two tiers:

* **in-memory LRU** — stores full :class:`CompiledDataflow` results
  (closure overrides included, so lowering/verification work on hits even
  for ad-hoc closure-built graphs).  Both ``put`` and ``get`` clone the
  graph, so callers can mutate results (e.g. lowering assigns fusion
  groups) without corrupting the cache.
* **on-disk pickle** (optional) — survives process restarts; this is what
  makes a second compile of the same design in a fresh process near-free.
  Tasks carry declarative :class:`~repro_torch.core.ops.OpSpec` semantics —
  plain data — so disk entries are *fully executable* after reload:
  a cold-restart hit lowers, executes and passes ``verify_lowering``
  without recompiling.  Only raw closure overrides (not picklable) are
  stripped at this boundary; a reloaded closure-built task falls back to
  a structural result (costing/reports/``verify_violation_free`` still
  work, lowering raises).  Executable disk hits are promoted into the
  memory tier; stripped ones are not.

With ``json_mirror`` (or ``CODO_CACHE_JSON=1``) every disk store also
writes the entry's versioned JSON artifact (``<key>.json``, the
``docs/artifact_format.md`` format) next to the pickle, so the disk tier
is *inspectable*: ``python -m repro_torch.core.artifact summary
<entry>.json`` — or either package's ``import_artifact``, or any
non-Python consumer — reads exactly what was cached.  Mirroring is
best-effort; closure-built entries (which cannot serialize) are skipped
silently.

Knobs: ``CODO_CACHE_SIZE`` (LRU entries, default 256), ``CODO_CACHE_DIR``
(enables the disk tier) and ``CODO_CACHE_JSON`` (JSON mirror) — read by
:func:`repro_torch.core.compiler.default_cache`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any

# Disk-entry file stem — what :meth:`CompileCache.key` produces:
# "<sha256 graph hash>-<16-hex options key>".  clear() only touches JSON
# files with this shape so user artifacts sharing the directory survive.
_KEY_RE = re.compile(r"^[0-9a-f]{64}-[0-9a-f]{16}$")


@dataclass
class CacheStats:
    hits: int = 0            # in-memory hits
    disk_hits: int = 0
    misses: int = 0
    stores: int = 0
    evictions: int = 0
    disk_errors: int = 0
    promotions: int = 0      # executable disk hits promoted to memory
    json_mirrors: int = 0    # artifact JSONs written next to pickles

    def summary(self) -> str:
        return (f"cache: {self.hits} hits, {self.disk_hits} disk hits, "
                f"{self.misses} misses, {self.stores} stores, "
                f"{self.evictions} evictions")


def _executable(compiled: Any) -> bool:
    """True when every task can produce a numeric fn (spec or closure) —
    i.e. the result can be lowered and executed as-is.  A stale entry
    whose spec kind is no longer registered counts as non-executable
    rather than raising."""
    try:
        return all(t.fn is not None for t in compiled.graph.tasks)
    except Exception:
        return False


def _clone(compiled: Any, *, strip_closures: bool = False) -> Any:
    """Defensive copy of a CompiledDataflow: fresh graph and buffer plan
    (``downgrade_to_pingpong`` mutates plans post-compile), with closure
    overrides dropped for pickle boundaries (``strip_closures`` — specs,
    being plain data, always survive).  The remaining reports are shared —
    nothing mutates them after compilation."""
    g = compiled.graph.copy()
    if strip_closures:
        for t in g.tasks:
            if t.fn_is_closure:
                t.fn = None
    bp = compiled.buffer_plan
    if bp is not None:
        bp = dataclasses.replace(bp, impl=dict(bp.impl),
                                 fifo_depth=dict(bp.fifo_depth),
                                 reasons=dict(bp.reasons))
    return dataclasses.replace(compiled, graph=g, buffer_plan=bp)


class CompileCache:
    """Thread-safe LRU of compile results, with an optional pickle tier."""

    def __init__(self, maxsize: int = 256, disk_dir: str | Path | None = None,
                 json_mirror: bool | None = None):
        self.maxsize = max(1, int(maxsize))
        self.disk_dir = Path(disk_dir) if disk_dir else None
        if json_mirror is None:
            json_mirror = os.environ.get("CODO_CACHE_JSON", "") \
                .lower() in ("1", "true", "yes")
        self.json_mirror = bool(json_mirror)
        self.stats = CacheStats()
        self._mem: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.RLock()

    # ---- keying ----------------------------------------------------------
    @staticmethod
    def key(graph: Any, options: Any) -> str:
        return f"{graph.structural_hash()}-{options.cache_key()[:16]}"

    # ---- lookup ----------------------------------------------------------
    def _disk_path(self, key: str) -> Path | None:
        return self.disk_dir / f"{key}.pkl" if self.disk_dir else None

    def get(self, key: str) -> Any | None:
        # Clone and unpickle outside the lock: entries are immutable once
        # inserted (both put and get hand out clones), so a bare reference
        # is safe to copy concurrently.
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self._mem.move_to_end(key)
                self.stats.hits += 1
        if entry is not None:
            return self._mark_hit(_clone(entry))
        path = self._disk_path(key)
        if path is not None and path.exists():
            try:
                entry = pickle.loads(path.read_bytes())
            except Exception:
                with self._lock:
                    self.stats.disk_errors += 1
            else:
                # Declarative entries are fully executable after reload and
                # earn promotion into the memory tier.  Closure-built
                # entries came back stripped; promoting those would poison
                # the memory tier's promise of full results.
                with self._lock:
                    self.stats.disk_hits += 1
                    if _executable(entry):
                        self._insert(key, entry)
                        self.stats.promotions += 1
                return self._mark_hit(_clone(entry))
        with self._lock:
            self.stats.misses += 1
        return None

    @staticmethod
    def _mark_hit(compiled: Any) -> Any:
        diag = getattr(compiled, "diagnostics", None)
        if diag is not None:
            compiled.diagnostics = dataclasses.replace(diag, cache_hit=True)
        return compiled

    # ---- store -----------------------------------------------------------
    def _insert(self, key: str, entry: Any) -> None:
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.maxsize:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    def put(self, key: str, compiled: Any) -> None:
        # Graph copies and pickling happen before taking the lock so a
        # batch-compile thread pool doesn't serialize on the cache.
        entry = _clone(compiled)
        blob = stripped = None
        path = self._disk_path(key)
        if path is not None:
            try:
                stripped = _clone(compiled, strip_closures=True)
                blob = pickle.dumps(stripped)
            except Exception:
                # Unpicklable report: the memory tier still works, so
                # degrade silently but count it.
                blob = None
                with self._lock:
                    self.stats.disk_errors += 1
        with self._lock:
            self._insert(key, entry)
            self.stats.stores += 1
        if blob is not None:
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_bytes(blob)
                tmp.replace(path)
            except Exception:
                with self._lock:
                    self.stats.disk_errors += 1
            else:
                if self.json_mirror:
                    self._mirror_json(path, stripped)

    def _mirror_json(self, pkl_path: Path, stripped: Any) -> None:
        """Write the entry's versioned JSON artifact next to its pickle —
        the disk tier's inspectable form.  ``stripped`` is the
        closure-free clone already built for the pickle blob.
        Closure-built entries cannot serialize and are skipped (expected,
        not an error); anything else — I/O failures included — counts in
        ``stats.disk_errors`` like the pickle path."""
        from .artifact import ArtifactError, dumps, export_artifact  # lazy
        try:
            doc = export_artifact(stripped)
            jtmp = pkl_path.with_suffix(f".{os.getpid()}.json.tmp")
            jtmp.write_text(dumps(doc))
            jtmp.replace(pkl_path.with_suffix(".json"))
            with self._lock:
                self.stats.json_mirrors += 1
        except ArtifactError:
            pass                      # closure/spec-less entry: expected skip
        except Exception:
            with self._lock:
                self.stats.disk_errors += 1

    # ---- tuning-database tier ----------------------------------
    @property
    def tuning_path(self) -> Path | None:
        """Where the disk tier keeps measured autotune results
        (``tuning.json``, a :class:`repro_torch.core.tuning.TuningDB` document);
        ``None`` for memory-only caches."""
        return self.disk_dir / "tuning.json" if self.disk_dir else None

    def load_tuning_db(self, merge_into_default: bool = True) -> int:
        """Merge the disk tier's persisted tuning entries into the process
        tuning database (so cached measured routing decisions survive
        process restarts like cached compiles do).  Returns the number of
        entries merged; 0 when there is nothing to load."""
        path = self.tuning_path
        if path is None or not path.exists():
            return 0
        from .tuning import TuningDB, default_tuning_db
        try:
            loaded = TuningDB.load(path)
        except (OSError, ValueError, KeyError):
            with self._lock:
                self.stats.disk_errors += 1
            return 0
        if merge_into_default:
            return default_tuning_db().merge(loaded.entries.values())
        return len(loaded)

    def save_tuning_db(self, db=None) -> Path | None:
        """Persist ``db`` (the process default when ``None``) to the disk
        tier's ``tuning.json``.  No-op for memory-only caches."""
        path = self.tuning_path
        if path is None:
            return None
        from .tuning import default_tuning_db
        (db if db is not None else default_tuning_db()).save(path)
        return path

    # ---- maintenance -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def clear(self, *, disk: bool = False) -> None:
        """Drop the memory tier and, with ``disk=True``, the cache's own
        disk files: pickles, their JSON mirrors (cache-key-named only —
        a user's hand-exported artifacts sharing the directory survive),
        and temp files orphaned by interrupted writes."""
        with self._lock:
            self._mem.clear()
            if disk and self.disk_dir is not None and self.disk_dir.exists():
                for p in self.disk_dir.glob("*.pkl"):
                    p.unlink(missing_ok=True)
                for p in self.disk_dir.glob("*.json"):
                    if _KEY_RE.match(p.stem):
                        p.unlink(missing_ok=True)
                for p in self.disk_dir.glob("*.tmp"):
                    p.unlink(missing_ok=True)


__all__ = ["CacheStats", "CompileCache"]
