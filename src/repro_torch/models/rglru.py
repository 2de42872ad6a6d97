"""The RG-LRU recurrence block in the dataflow-frontend vocabulary.

The port's copy of ``rglru_block_fn`` from ``repro/models/rglru.py``: the
gated recurrence core as a traced function, so the ``rglru_scan`` op
reaches the ``rglru.scan`` kernel through routing.  The rest of that
module (the RecurrentGemma layer stack) belongs to the LM stack, which
is not ported yet.
"""


def rglru_block_fn(a, gate, x):
    """Gated linear-recurrence block over ``(B, S, D)`` operands:
    ``h = scan(a, gate*x)`` with a residual skip."""
    from ..core import frontend as F
    b = F.mul(gate, x)
    h = F.rglru_scan(a, b)
    return F.add(h, x)
