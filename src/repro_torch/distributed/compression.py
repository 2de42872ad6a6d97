"""Int8 gradient compression with error feedback (the port's copy of
``repro/distributed/compression.py``, on nests of dicts of tensors).

Per-tensor symmetric quantization: q = round(g / s), s = max|g| / 127
(round half to even, as ``jnp.round``).  The quantization residual is
carried as error feedback ("ef" buffers) and added back before the next
quantization — the standard correction that keeps compressed SGD/Adam
convergent.  :func:`wire_bytes` prices the payload: one byte a gradient
and a float32 scale a tensor, against the tensor's own bytes.

The reference's ``compressed_allreduce`` quantizes against a scale shared
through ``pmax`` and sums the int8 payloads with ``psum`` inside
``shard_map``: it waits for the sharded train step (``ROADMAP.md``,
Queue 1 item 7b).
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


def wire_bytes(tree: Any, compressed: bool) -> int:
    leaves = tree_leaves(tree)
    if compressed:
        return sum(x.numel() * 1 + 4 for x in leaves)
    return sum(x.numel() * x.element_size() for x in leaves)


__all__ = ["compress_tree", "dequantize", "quantize", "wire_bytes"]
