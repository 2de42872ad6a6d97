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
prompt fed one token a step, as in the reference.  The reference's
``jit_serve_step`` / ``jit_prefill_step`` take a mesh and GSPMD
shardings: they wait for the sharded train step (``ROADMAP.md``, Queue 1
item 7b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..models.layers import tree_from_paths, tree_leaves, tree_paths


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


__all__ = ["Generator", "Request", "ServeStep", "build_prefill_step",
           "build_serve_step"]
