"""Serving: the decode and prefill steps + a batched generation driver.

The port's copy of ``repro/serving/generator.py``.  ``build_serve_step``
is one new token for every sequence in the batch against a KV cache /
recurrent state, the cache written in place (the reference donates it to
``jax.jit``).

Where the reference ``jax.jit``s the step, :class:`ServeStep` captures it
into a CUDA graph on the card through
:class:`~repro_torch.core.capture.CapturedProgram`: once per generator,
with the token buffer, the parameters and the generator's cache bound
where they lie (a copy of the weights on every call would move 0.7 GB a
token at GPT-2 medium).  Its first call runs the step eagerly on a side
stream and then captures it; every later call replays the graph.  A step
that cannot be captured raises
:class:`~repro_torch.core.capture.CaptureError` and never runs eagerly
instead.  On the CPU the step runs eagerly.

``Generator`` is the runnable driver: greedy sampling, slot-based
continuous batching (finished sequences are replaced by queued requests
without capturing again), one shared position for every slot and the
prompt fed one token a step, as in the reference.

On a mesh, :func:`jit_serve_step` and :func:`jit_prefill_step` are the
reference's steps with their in and out shardings (parameters by
``param_specs``, the cache by ``cache_specs``, the batch by
``batch_specs``), run by the lockstep executor of
:mod:`~repro_torch.distributed.spmd`: the parameters gathered over the
data axes, the model run once for each data-parallel block of the batch,
each model position computing its part (heads, columns, experts, vocab
slice).  The serve step's cache is donated: every position reads and
writes its own cache shards where they lie, nothing of the cache is
gathered, and the step is captured into one CUDA graph on the card as
:class:`ServeStep` is.  Under ``REPRO_DECODE_WSTAT`` its dense weights are
not gathered at all: each position contracts its FSDP shard and the
partial sums meet over ``data``.  Its tokens come back placed over the data axes,
its logits whole; the prefill step runs eagerly, as the unsharded prefill
does, and returns its logits whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed import spmd
from ..distributed.sharding import (BATCH, P, NamedSharding, PlacedArray,
                                    as_shardings, batch_specs,
                                    cache_specs,
                                    param_specs, place, use_mesh)
from ..models import transformer as tf
from ..models.layers import (tree_from_paths, tree_leaves, tree_map,
                             tree_paths)


def build_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, tokens, cache):
        logits, cache = tf.decode_step(params, tokens, cache, cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return serve_step


def build_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        return tf.prefill(params, batch, cfg)
    return prefill_step


class ServeStep:
    """The serve step of ``cfg`` bound to ``params`` and ``cache`` (both
    on one device), over a token buffer of ``batch`` slots:
    ``step(tokens)`` writes the cache in place and returns ``(next_tok,
    logits)``.  It is a :class:`~repro_torch.core.capture.CapturedProgram`
    of one step, ``decode_step``, whose every env entry (the token buffer,
    each parameter and each cache leaf) is bound: captured where it lies
    and never copied."""

    def __init__(self, cfg: ArchConfig, params, cache, batch: int):
        from ..core.capture import CapturedProgram
        self.params, self.cache = params, cache
        self.device = cache["pos"].device
        self.tokens = torch.zeros((batch,), dtype=torch.int32,
                                  device=self.device)
        self.env = {"tokens": self.tokens, **tree_paths(params, "params"),
                    **tree_paths(cache, "cache")}
        serve_step = build_serve_step(cfg)

        def decode(scope):
            nxt, logits, _ = serve_step(
                tree_from_paths(params, scope, "params"), scope["tokens"],
                tree_from_paths(cache, scope, "cache"))
            return {"next_tok": nxt, "logits": logits}

        self.program = CapturedProgram([("decode_step", decode)],
                                       ["next_tok", "logits"],
                                       bound=self.env)

    def __call__(self, tokens):
        self.tokens.copy_(torch.as_tensor(np.asarray(tokens, np.int32)))
        out = self.program(self.env)
        return out["next_tok"], out["logits"]


# --------------------------------------------------------------------------
# The sharded steps (the reference's jit_serve_step / jit_prefill_step)
# --------------------------------------------------------------------------


def _dp(mesh) -> tuple:
    return tuple(a for a in BATCH if a in mesh.axis_names)


class ShardedServeStep:
    """The serve step of ``cfg`` on ``mesh`` with the reference's in and
    out shardings: ``step(params, tokens, cache) -> (next_tok, logits,
    cache)``.  Parameters are placed by ``param_specs`` and the cache by
    ``cache_specs`` (leaves given unplaced are placed first); the cache is
    donated, every position's shards written in place.  ``tokens`` (B,)
    is copied into the step's buffer, split over the data axes;
    ``next_tok`` comes back placed so, ``logits`` whole on the mesh's
    first device.  Each data-parallel block of the batch decodes once,
    each model position computing its part against its own cache shards
    (:func:`~repro_torch.distributed.spmd.cache_view`), read and written
    where they lie."""

    def __init__(self, cfg: ArchConfig, mesh, pspecs, cspecs, *,
                 jit: bool = True):
        self.cfg, self.mesh = cfg, mesh
        self.pshard = as_shardings(pspecs, mesh)
        self.cshard = as_shardings(cspecs, mesh)
        self.tshard = NamedSharding(mesh, P(_dp(mesh)))
        self.tokens: PlacedArray | None = None
        self._cur = None
        self.runner = spmd.LockstepStep(mesh, "decode_step", self._body,
                                        ["next_tok", "logits"], jit=jit)

    def _body(self) -> dict:
        params, tokens, cache = self._cur
        cfg = self.cfg
        tok = tokens.gather()
        pos = cache["pos"]._first_local()

        def decode(unit, r0, r1):
            view = spmd.cache_view(cache, r0, r1, pos.clone())
            lg, _ = tf.decode_step(unit, tok[r0:r1], view, cfg)
            return {"next_tok": torch.argmax(lg, dim=-1).to(torch.int32),
                    "logits": lg}

        out = spmd.over_blocks(
            params, spmd.compute_blocks(tok.shape[0],
                                        tokens.sharding.parts(0), 1,
                                        spmd.moe_chunk(cfg)),
            decode, "cat",
            split=tf.tp_split(cfg, self.mesh.shape.get("model", 1)),
            wstat=tf._DECODE_WSTAT)
        for s_ in cache["pos"].local_shards().values():
            s_.add_(1)
        for path, leaf in tree_paths(cache, "").items():
            if not path.endswith(("/pos", "/enc_out")):   # enc_out: read only
                spmd.sync_replicas(leaf)
        return out

    def __call__(self, params, tokens, cache):
        params = place(params, self.pshard)
        cache = place(cache, self.cshard)
        if isinstance(tokens, PlacedArray):
            tokens = tokens.gather()
        t = torch.as_tensor(np.array(tokens, np.int32)
                            if not isinstance(tokens, torch.Tensor)
                            else tokens.to(torch.int32))
        if self.tokens is None or self.tokens.shape != tuple(t.shape):
            self.tokens = place(t, self.tshard)
        else:
            spmd.write_blocks(self.tokens, t)
        self._cur = (params, self.tokens, cache)
        try:
            out = self.runner(spmd.shard_env(
                {"params": params, "tokens": self.tokens, "cache": cache},
                ""))
        finally:
            self._cur = None
        return place(out["next_tok"], self.tshard), out["logits"], cache


def jit_serve_step(cfg: ArchConfig, mesh, params_or_shapes, cache_like, *,
                   jit: bool = True) -> ShardedServeStep:
    """The decode step with explicit in / out shardings over ``mesh`` (the
    reference's ``jit_serve_step``): parameters by ``param_specs``, tokens
    over the data axes, the cache by ``cache_specs`` and donated.  On the
    card it is captured into one CUDA graph (``jit=False``: eager)."""
    return ShardedServeStep(cfg, mesh, param_specs(params_or_shapes, mesh,
                                                   cfg),
                            cache_specs(cache_like, mesh, cfg), jit=jit)


class ShardedPrefillStep:
    """The prefill step of ``cfg`` on ``mesh``: ``step(params, batch) ->
    logits`` (B, vocab), whole.  Parameters placed by ``param_specs``; each
    data-parallel block of the batch (its shards by ``batch_specs``) runs
    ``prefill`` once, each model position computing its part, eagerly."""

    def __init__(self, cfg: ArchConfig, mesh, pspecs, bspecs):
        self.cfg, self.mesh = cfg, mesh
        self.pshard = as_shardings(pspecs, mesh)
        self.bshard = as_shardings(bspecs, mesh)

    def __call__(self, params, batch: dict):
        cfg = self.cfg
        params = place(params, self.pshard)
        device = self.mesh.local_devices[0]
        batch = {k: v.to(device) for k, v in
                 spmd.whole_batch(batch, cfg.tdtype).items()}
        blocks = spmd.compute_blocks(
            batch["tokens"].shape[0], self.bshard["tokens"].parts(0),
            batch["tokens"].shape[1] + cfg.n_patches, spmd.moe_chunk(cfg))
        with use_mesh(self.mesh):
            return spmd.over_blocks(
                params, blocks, lambda unit, r0, r1: tf.prefill(
                    unit, {k: v[r0:r1] for k, v in batch.items()}, cfg),
                "cat", split=tf.tp_split(cfg, self.mesh.shape.get("model",
                                                                  1)))


def jit_prefill_step(cfg: ArchConfig, mesh, params_or_shapes, batch_like
                     ) -> ShardedPrefillStep:
    """The prefill step with explicit in shardings over ``mesh`` (the
    reference's ``jit_prefill_step``): parameters by ``param_specs``, the
    batch by ``batch_specs``; the logits come back whole."""
    return ShardedPrefillStep(cfg, mesh,
                              param_specs(params_or_shapes, mesh, cfg),
                              batch_specs(batch_like, mesh))


# --------------------------------------------------------------------------
# Generation driver
# --------------------------------------------------------------------------


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    done: bool = False


class Generator:
    """Slot-based batched decoding with greedy sampling, on the device of
    ``params``."""

    def __init__(self, cfg: ArchConfig, params, batch: int, cache_len: int):
        self.cfg, self.params = cfg, params
        self.batch, self.cache_len = batch, cache_len
        device = tree_leaves(params)[0].device
        self.cache = tf.init_cache(cfg, batch, cache_len, device=device)
        self.step_fn = ServeStep(cfg, params, self.cache, batch)
        self.slots: list[Request | None] = [None] * batch
        self.queue: list[Request] = []
        self.tokens = np.zeros((batch,), np.int32)
        self.steps = 0
        self.tokens_out = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # feed the prompt one token at a time (prefill-by-decode —
                # fine at example scale; production prefill uses prefill())
                self.tokens[i] = req.prompt[0]
                req._cursor = 1  # type: ignore[attr-defined]

    def step(self) -> None:
        self._fill_slots()
        nxt, _logits = self.step_fn(self.tokens)
        nxt = nxt.cpu().numpy()
        self.steps += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            cur = getattr(req, "_cursor", len(req.prompt))
            if cur < len(req.prompt):
                self.tokens[i] = req.prompt[cur]
                req._cursor = cur + 1  # type: ignore[attr-defined]
            else:
                req.out.append(int(nxt[i]))
                self.tokens[i] = int(nxt[i])
                self.tokens_out += 1
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.slots[i] = None

    def run(self, max_steps: int = 256) -> list[Request]:
        finished: list[Request] = []
        pending = list(self.queue)
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
            for r in pending:
                if r.done and r not in finished:
                    finished.append(r)
        return finished


__all__ = ["Generator", "Request", "ServeStep", "ShardedPrefillStep",
           "ShardedServeStep", "build_prefill_step", "build_serve_step",
           "jit_prefill_step", "jit_serve_step"]
