"""The lockstep executor behind the LM stack's sharded steps.

The reference hands a train, serve or prefill step to ``jax.jit`` with
per-leaf shardings, and GSPMD partitions it however it likes, promising
the unsharded step's results.  The port keeps that promise with one
explicit scheme on its single-controller mesh (one process drives every
position of a :class:`~repro_torch.launch.mesh.Mesh` in lockstep):

* state lives as :class:`~repro_torch.distributed.sharding.PlacedArray`\\ s,
  one local tensor a position: parameters and optimizer state by
  ``param_specs`` (FSDP over ``data``, tensor-parallel dims over
  ``model``), the batch by ``batch_specs``, the decode cache by
  ``cache_specs``;
* a step all-gathers the leaves it reads, runs the model once for each
  *compute block* of the batch — one block a data-parallel shard, so the
  positions that share data coordinates (and therefore batch and weights)
  share one computation; computing along ``model`` is replicated —
  reduces across the blocks in position order (:func:`over_blocks`, the
  body that the train, serve and prefill steps share), and writes each
  position's slice of the result into its own tensors, in place where the
  reference donates them.

A MoE layer sizes its dispatch capacity per chunk of ``min(1024, T)``
tokens of the whole batch, so blocks whose tokens share a chunk are
computed together (:func:`compute_blocks`): the drops are those of the
unsharded step.

:class:`LockstepStep` runs such a step: eagerly on the CPU or with
``jit=False``; on the card, with every position on that card, captured
into one CUDA graph through :class:`~repro_torch.core.capture.
CapturedProgram` with every shard bound (read and written where it lies,
never copied).  A step that cannot be captured raises
:class:`~repro_torch.core.capture.CaptureError`, and so does ``jit=True``
on a mesh over several cards, whose collectives between cards are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

from .sharding import PlacedArray, current_mesh, gather, use_mesh

__all__ = ["LockstepStep", "compute_blocks", "moe_chunk", "over_blocks",
           "shard_env", "whole_batch", "write_blocks"]

ITEM_10 = "ROADMAP.md, Queue 1 item 10 (Multi-card meshes)"


def moe_chunk(cfg) -> int | None:
    """The token chunk of ``cfg``'s MoE dispatch (None without MoE), as
    ``models/layers.py: moe_apply`` reads it."""
    if cfg.moe is None:
        return None
    from ..models import layers
    return layers._MOE_CHUNK or 1024


def compute_blocks(rows: int, parts: int, row_tokens: int,
                   chunk: int | None = None) -> list[tuple[int, int]]:
    """The ``(start, stop)`` rows of each compute block of a batch of
    ``rows`` rows split into ``parts`` data-parallel shards (one block a
    shard, in order; one block when ``parts`` does not divide ``rows``).
    With a MoE ``chunk`` (tokens), consecutive shards are merged until a
    block holds whole dispatch chunks of ``min(chunk, rows · row_tokens)``
    tokens, so no chunk spans two blocks."""
    if parts < 1 or rows % parts:
        parts = 1
    per = rows // parts
    k = 1
    if chunk:
        whole = min(chunk, rows * row_tokens)
        k = next(j for j in range(1, parts + 1)
                 if parts % j == 0 and (j * per * row_tokens) % whole == 0)
    return [(i * per * k, (i + 1) * per * k) for i in range(parts // k)]


def over_blocks(params: Any, blocks: list[tuple[int, int]],
                fn: Callable, combine: str, *, microbatches: int = 1) -> Any:
    """The body of every sharded step: gather the placed leaves of
    ``params`` once, run ``fn(whole_params, r0, r1)`` on each compute block
    ``(r0, r1)`` in order, and combine its results (a dict of tensors each,
    nested alike) leaf by leaf: ``"cat"`` concatenates them along dim 0,
    ``"sum"`` adds them in float32 in block order into one running sum, so
    one block's results are alive beside it at a time.  The gathered
    parameters are dropped before it returns.

    ``blocks`` may span ``microbatches`` equal microbatches one after
    another.  Under a cost walker (:mod:`repro_torch.launch.hlo_analysis`)
    each block runs at the share of the positions that compute it (its
    rows over a microbatch's), and the combination is one collective over
    the data axes: the sum an all-reduce, the concatenation an
    all-gather.  On meta parameters a block's result and cost follow from
    its row count alone, so a block of a row count already run is charged
    that block's cost again and returns its result
    (:meth:`~repro_torch.launch.hlo_analysis.CostWalker.repeat`)."""
    import torch

    from ..launch import hlo_analysis
    from ..models.layers import tree_leaves, tree_map
    walker = hlo_analysis.active()
    rows = sum(r1 - r0 for r0, r1 in blocks) / microbatches
    whole = gather(params)
    on_meta = all(t.device.type == "meta" for t in tree_leaves(whole))
    parts, acc, ran = [], None, {}
    for r0, r1 in blocks:
        if walker is None:
            out = fn(whole, r0, r1)
        elif on_meta and (r1 - r0) in ran:
            out = walker.repeat(ran[r1 - r0])
        else:
            with walker.block() as blk, walker.share((r1 - r0) / rows):
                out = fn(whole, r0, r1)
            ran[r1 - r0] = blk.result(out)
        with hlo_analysis.muted():
            if combine == "cat":
                parts.append(out)
            elif acc is None:
                acc = tree_map(lambda t: t.float(), out)
            else:
                for a, t in zip(tree_leaves(acc), tree_leaves(out)):
                    a.add_(t.float())
    del whole
    with hlo_analysis.muted():
        result = acc if combine == "sum" else tree_map(
            lambda *ts: torch.cat(ts), *parts)
    if walker is not None:
        mesh = current_mesh()
        group = (hlo_analysis.group_size(mesh, _data_axes(mesh))
                 if mesh is not None else len(blocks) // microbatches)
        nbytes = sum(hlo_analysis.tensor_bytes(t)
                     for t in tree_leaves(result))
        walker.collective("all-reduce" if combine == "sum" else "all-gather",
                          nbytes, group)
    return result


def _data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def whole_batch(batch: dict, float_dtype) -> dict:
    """A batch of numpy arrays, tensors or placed arrays as whole tensors
    (placed ones gathered), float inputs (frames, patch embeddings) in
    ``float_dtype``, the model's."""
    import numpy as np
    import torch
    out = {}
    for k, v in batch.items():
        if isinstance(v, PlacedArray):
            v = v.gather()
        t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.array(v))
        out[k] = t.to(float_dtype) if t.is_floating_point() else t
    return out


def shard_env(tree: Any, prefix: str) -> dict:
    """``{name: shard}`` of every position's shard of every placed leaf of
    ``tree`` (other leaves by their path): the env a captured step binds."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, PlacedArray):
            for p, s in enumerate(t.shards):
                out[f"{path}@{p}"] = s
        else:
            out[path] = t

    walk(tree, prefix)
    return out


def write_blocks(placed: PlacedArray, full) -> None:
    """Write every position's slice of the whole array ``full`` into its
    shard, in place: each block computed once, then copied to every
    position that holds it."""
    sh = placed.sharding
    for p, s in enumerate(placed.shards):
        s.copy_(sh.local(full, p))


class LockstepStep:
    """One step of a sharded program over ``mesh``: ``body()`` runs every
    position's share in lockstep (reading and writing the placed trees it
    closes over) and returns ``{output name: tensor}``; ``env`` names the
    tensors it reads and writes (:func:`shard_env`).  Each call runs with
    the mesh ambient.  With ``jit`` and every position on one card the
    step is captured into one CUDA graph at its first call (which runs
    eagerly), every env entry bound, and replayed after; the CPU and
    ``jit=False`` run it eagerly."""

    def __init__(self, mesh, name: str, body: Callable[[], dict],
                 outputs: list[str], *, jit: bool = True):
        self.mesh, self.name, self.jit = mesh, name, jit
        self.body = body
        self.outputs = list(outputs)
        self.program = None

    def _step(self, scope: dict) -> dict:
        del scope                       # the body reads its bound trees
        with use_mesh(self.mesh):
            return self.body()

    def __call__(self, env: dict) -> dict:
        from ..core.capture import CaptureError, CapturedProgram, run_steps
        steps = [(self.name, self._step)]
        devices = self.mesh.distinct_devices
        on_card = any(d.type == "cuda" for d in devices)
        if not self.jit or not on_card:
            return run_steps(steps, self.outputs, env)
        if len(devices) > 1:
            raise CaptureError(
                f"jit=True on {self.mesh!r}: capturing a step whose positions "
                f"sit on several devices is not ported yet ({ITEM_10}); run "
                f"it with jit=False, or place every position on one card")
        if self.program is None or set(env) != self.program.bound:
            self.program = CapturedProgram(steps, self.outputs,
                                           bound=list(env))
        return self.program(env)
