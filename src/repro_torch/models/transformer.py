"""Batched attention in the dataflow-frontend vocabulary.

The port's copy of ``mha_batched_fn`` from ``repro/models/transformer.py``:
one attention head over ``(BH, S, hd)`` operands, so ``codo_torch.compile``
sees the matmul -> scale -> softmax -> matmul chain the ``flashattn.mha``
pattern routes.  The rest of that module (the LM stack) is not ported
yet.
"""

import math


def mha_batched_fn(q, k, v):
    """Batched single-head attention ``softmax(q kᵀ / √hd) v``; operands
    are ``(BH, S, hd)`` (heads folded into the leading batch dim)."""
    from ..core import frontend as F
    hd = q.shape[-1]
    kt = F.transpose(k)                       # (BH, hd, S)
    s = F.scale(F.matmul(q, kt), 1.0 / math.sqrt(hd))
    p = F.softmax(s)
    return F.matmul(p, v)
