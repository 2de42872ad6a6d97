"""Int8 gradient compression with error feedback (the port's copy of
``repro/distributed/compression.py``, on nests of dicts of tensors).

Per-tensor symmetric quantization: q = round(g / s), s = max|g| / 127
(round half to even, as ``jnp.round``).  The quantization residual is
carried as error feedback ("ef" buffers) and added back before the next
quantization — the standard correction that keeps compressed SGD/Adam
convergent.  :func:`wire_bytes` prices the payload: one byte a gradient
and a float32 scale a tensor, against the tensor's own bytes.

:func:`compressed_allreduce` is the reference's all-reduce of int8
payloads inside ``shard_map``: every position quantizes against a scale
shared through ``pmax``, and the payloads are summed in int32 by ``psum``
(the in-step collectives of
:mod:`~repro_torch.distributed.collectives`, under the port's
:func:`~repro_torch.distributed.sharding.shard_map`).
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map


def quantize(g) -> tuple:
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_tree(grads: Any, ef: Any | None = None):
    """Quantize every leaf (+error feedback).  Returns (q_tree, scale_tree,
    new_ef_tree)."""
    if ef is None:
        ef = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef)
    qs = tree_map(quantize, corrected)
    q = tree_map(lambda t: t[0], qs)
    s = tree_map(lambda t: t[1], qs)
    new_ef = tree_map(lambda c, qq, ss: c - dequantize(qq, ss),
                      corrected, q, s)
    return q, s, new_ef


def compressed_allreduce(grads: Any, opt_state: dict,
                         axes: tuple[str, ...]) -> tuple[Any, dict]:
    """Compressed gradient all-reduce with error feedback kept in
    ``opt_state["ef"]``, for code running under ``shard_map``.

    All positions quantize against a *shared* scale (``pmax`` of the local
    abs-max): the int32-accumulated payload then dequantizes exactly as
    scale · Σ q_r.  Returns the summed float32 gradients and the state
    with the new error feedback (the state is not changed in place)."""
    from .collectives import pmax, psum
    ef = opt_state.get("ef")
    if ef is None:
        ef = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef)

    def leaf_reduce(c):
        amax = pmax(torch.max(torch.abs(c)), axes)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
        summed = psum(q.to(torch.int32), axes)
        return summed.float() * scale, c - q.float() * scale

    pairs = tree_map(leaf_reduce, corrected)
    new_state = dict(opt_state)
    new_state["ef"] = tree_map(lambda t: t[1], pairs)
    return tree_map(lambda t: t[0], pairs), new_state


def wire_bytes(tree: Any, compressed: bool) -> int:
    leaves = tree_leaves(tree)
    if compressed:
        return sum(x.numel() * 1 + 4 for x in leaves)
    return sum(x.numel() * x.element_size() for x in leaves)


__all__ = ["compress_tree", "compressed_allreduce", "dequantize", "quantize",
           "wire_bytes"]
