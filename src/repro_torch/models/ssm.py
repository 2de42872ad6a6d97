"""The Mamba-2 SSD inter-chunk recurrence in the dataflow-frontend
vocabulary.

The port's copy of ``ssd_block_fn`` from ``repro/models/ssm.py``: the
state recurrence across chunks as a traced function, so the ``ssd_scan``
op reaches the ``ssd.scan`` kernel through routing.  The rest of that
module (the Mamba-2 layer stack) belongs to the LM stack, which is not
ported yet.
"""


def ssd_block_fn(states, decay):
    """Inter-chunk SSD recurrence over per-chunk end ``states
    (nc, BH, P, N)`` and scalar ``decay (nc, BH, 1, 1)``; returns the
    carried-in states combined with the locals (residual form)."""
    from ..core import frontend as F
    prev = F.ssd_scan(states, decay)
    return F.add(prev, states)
