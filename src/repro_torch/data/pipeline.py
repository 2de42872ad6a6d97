"""Deterministic sharded synthetic data pipeline with background prefetch.

The port's copy of ``repro/data/pipeline.py``, framework-free: batches are
numpy arrays (the train loop moves them to the device), drawn by the
reference's numpy code in its order, so the two packages' batches agree
bit for bit.

Production posture without external deps:

* **Determinism & elasticity** — batch(step) is a pure function of
  (seed, step, global layout), so restarts and re-sharded restarts replay
  the exact token stream: host h of H regenerates its slice from the
  global index space regardless of H (elastic re-mesh safe).
* **Prefetch** — a daemon thread keeps a bounded queue of ready batches
  (double buffering the host→device copy against the step).
* **Packing** — documents of geometric length are packed into fixed
  (batch, seq) windows with -100-masked boundaries, which exercises the
  loss mask path the way a real LM mixture would.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    mask_boundaries: bool = True
    num_hosts: int = 1
    host_index: int = 0


class SyntheticLM:
    """Deterministic synthetic token stream."""

    def __init__(self, cfg: ArchConfig, dc: DataConfig):
        assert dc.global_batch % dc.num_hosts == 0
        self.cfg, self.dc = cfg, dc
        self.local_batch = dc.global_batch // dc.num_hosts

    def _row(self, step: int, global_row: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.dc.seed * 1_000_003 + step) * 65_537 + global_row)
        s = self.dc.seq_len
        toks = rng.integers(1, self.cfg.vocab, size=s + 1, dtype=np.int64)
        if self.dc.mask_boundaries:
            # pack geometric-length documents; boundary target is masked
            pos = 0
            while pos < s:
                ln = int(rng.geometric(1.0 / self.dc.mean_doc_len))
                pos += max(ln, 1)
                if pos <= s:
                    toks[pos - 1] = 0  # EOD
        return toks

    def batch(self, step: int) -> dict:
        rows = [self._row(step, self.dc.host_index * self.local_batch + r)
                for r in range(self.local_batch)]
        arr = np.stack(rows)
        tokens = arr[:, :-1].astype(np.int32)
        labels = arr[:, 1:].astype(np.int32)
        if self.dc.mask_boundaries:
            labels = np.where(tokens == 0, -100, labels)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.n_patches:
            rng = np.random.default_rng(self.dc.seed * 7 + step)
            out["tokens"] = out["tokens"][:, :self.dc.seq_len - self.cfg.n_patches]
            out["labels"] = out["labels"][:, :self.dc.seq_len - self.cfg.n_patches]
            out["patch_embeds"] = rng.standard_normal(
                (self.local_batch, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.enc_dec:
            rng = np.random.default_rng(self.dc.seed * 13 + step)
            out["frames"] = rng.standard_normal(
                (self.local_batch, self.cfg.enc_frames, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


class Prefetcher:
    """Bounded background prefetch over any ``batch(step)`` source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.q.get()

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
