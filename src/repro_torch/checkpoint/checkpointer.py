"""Async, manifest-verified checkpointing (the port's copy of
``repro/checkpoint/checkpointer.py``, on nests of dicts of tensors).

Layout per step, the reference's:

    <dir>/step_<N>/
        manifest.json      {step, leaf paths, shapes, dtypes, checksums}
        <leaf-hash>.npy    one file per leaf

* **Key paths** — a leaf's key is its dict keys joined by ``"/"``, leaves
  in sorted key order (``jax.tree_util``'s order), and its file name the
  first 16 hex digits of the key's SHA-1: the same files as the
  reference's for the same tree.
* **Async** — ``save()`` copies every leaf to host numpy synchronously and
  writes the files on a background thread; ``wait()`` joins.
* **Integrity** — restore verifies each leaf's checksum and
  ``restore_latest`` falls back to the newest *complete* checkpoint (a
  torn write never poisons a restart); ``keep`` checkpoints are kept.
* **Dtypes** — a bfloat16 leaf is written as float32, which holds it
  exactly (as :func:`repro_torch.models.params_from_numpy` carries one),
  so the reference restores it; a reference checkpoint's bfloat16 leaf
  (numpy's raw ``|V2``) is read by its bits.  Restore puts each leaf on
  the ``like`` tree's device, in its dtype.
* **Elastic** — leaves are stored whole: ``save`` gathers a leaf placed
  on a mesh (:class:`~repro_torch.distributed.sharding.PlacedArray`), and
  ``restore(..., shardings=...)`` places each leaf by its
  :class:`~repro_torch.distributed.sharding.NamedSharding` on that
  sharding's mesh, which may be smaller than the one that saved it.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key path, leaf)`` of a nest of dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _treedef(tree: Any) -> str:
    """The tree's structure as ``jax.tree_util`` prints it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    import torch

    from ..distributed.sharding import PlacedArray
    if isinstance(leaf, PlacedArray):
        if leaf.sharding.mesh.distributed:
            raise NotImplementedError(
                "checkpoints of a mesh split over ranks are not ported yet "
                "(ROADMAP.md, Queue 1 item 10 (Multi-card meshes))")
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> list[tuple[str, np.ndarray]]:
    return [(key, _to_numpy(leaf)) for key, leaf in _paths(tree)]


def _as_tensor(arr: np.ndarray, dtype: str, like):
    """A stored leaf as a tensor on ``like``'s device in its dtype (on the
    CPU in the stored dtype when ``like`` is no tensor)."""
    import torch
    if dtype == "bfloat16":             # the reference's raw bfloat16 bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        flat = _flatten(state)          # synchronous host snapshot
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, _treedef(state)),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, flat, treedef_repr: str) -> None:
        tmp = self.dir / f".tmp_step_{step}_{time.time_ns()}"
        tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "leaves": [], "treedef": treedef_repr,
                    "time": time.time()}
        for key, arr in flat:
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append({
                "key": key, "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "checksum": hashlib.sha1(arr.tobytes()).hexdigest()[:16],
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)               # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _load(self, step: int, verify: bool = True) -> dict[str, tuple]:
        """``{key: (array, manifest dtype)}`` of a step's leaves."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = {}
        for entry in manifest["leaves"]:
            arr = np.load(d / entry["file"])
            if verify:
                chk = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
                if chk != entry["checksum"]:
                    raise IOError(f"checksum mismatch for {entry['key']} "
                                  f"at step {step}")
            leaves[entry["key"]] = (arr, entry["dtype"])
        return leaves

    def restore(self, step: int, like: Any, shardings: Any | None = None
                ) -> Any:
        """Restore into the structure of ``like`` (its values ignored), each
        leaf in its ``like`` leaf's dtype: on that leaf's device, or placed
        by its sharding when ``shardings`` (a tree mirroring ``like`` of
        :class:`~repro_torch.distributed.sharding.NamedSharding` or
        ``None``) gives one — the elastic re-mesh path."""
        from ..distributed.sharding import place
        leaves = self._load(step)

        def walk(t, sh, prefix):
            if isinstance(t, dict):
                return {k: walk(v, sh[k] if isinstance(sh, dict) else sh,
                                prefix + (str(k),)) for k, v in t.items()}
            arr, dtype = leaves["/".join(prefix)]
            if sh is None:
                return _as_tensor(arr, dtype, t)
            whole = _as_tensor(arr, dtype, None)
            return place(whole.to(getattr(t, "dtype", whole.dtype)), sh)

        return walk(like, shardings, ())

    def restore_latest(self, like: Any | None = None,
                       shardings: Any | None = None):
        """(step, state) from the newest checkpoint that verifies; torn or
        corrupt checkpoints are skipped.  With no ``like``, state is the
        raw ``{key: numpy array}`` of the leaves."""
        for step in reversed(self.steps()):
            try:
                if like is None:
                    return step, {k: a for k, (a, _) in
                                  self._load(step).items()}
                return step, self.restore(step, like, shardings)
            except Exception:
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")


__all__ = ["Checkpointer"]
