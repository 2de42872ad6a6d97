"""On-chip communication-buffer determination (paper §V-A).

FIFO-first strategy: every internal edge whose producer/consumer streams
are compatible after the correctness passes becomes a FIFO; everything
else falls back to a ping-pong (double) buffer.

TPU mapping — a FIFO edge means the two tasks are *fusable into one
streaming kernel*: the intermediate lives only as a VMEM tile (its "FIFO
depth").  A ping-pong edge means the intermediate is materialized in HBM
and the consumer's Pallas grid pipeline double-buffers the HBM→VMEM DMA —
the exact latency/flexibility trade of Fig. 1.  Resource accounting
follows: FIFO costs `depth × itemsize` of VMEM, ping-pong costs
`2 × block-bytes` (of HBM plus a VMEM staging tile).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import FIFO, PINGPONG, DataflowGraph
from .patterns import fine_violations_edge

# Pipeline declaration consumed by passes.default_passes().  Always runs:
# even the Opt1/Opt2 ablations need every edge classified FIFO/ping-pong
# before the cost model can evaluate the design.
PASS_INFO = {
    "name": "buffers",
    "result_attr": "buffer_plan",
    "option_flag": None,
    "invalidates": (),
    "description": "communication-buffer determination (FIFO-first, §V-A)",
}


@dataclass
class BufferPlan:
    impl: dict[str, str] = field(default_factory=dict)          # buffer -> FIFO/PINGPONG
    fifo_depth: dict[str, int] = field(default_factory=dict)    # elements
    reasons: dict[str, str] = field(default_factory=dict)
    vmem_bytes: int = 0
    hbm_bytes: int = 0

    def fifo_fraction(self) -> float:
        """Table VIII's metric: share of internal buffers implemented as
        FIFOs."""
        if not self.impl:
            return 1.0
        n = sum(1 for v in self.impl.values() if v == FIFO)
        return n / len(self.impl)

    def summary(self) -> str:
        return (f"buffers: {sum(1 for v in self.impl.values() if v == FIFO)} FIFO / "
                f"{sum(1 for v in self.impl.values() if v == PINGPONG)} ping-pong "
                f"({self.fifo_fraction():.0%} FIFO), vmem={self.vmem_bytes}B "
                f"hbm={self.hbm_bytes}B")

    # ---- JSON serialization (docs/artifact_format.md `buffer_plan`) ------
    def to_dict(self) -> dict:
        return {"impl": dict(self.impl), "fifo_depth": dict(self.fifo_depth),
                "reasons": dict(self.reasons), "vmem_bytes": self.vmem_bytes,
                "hbm_bytes": self.hbm_bytes}

    @classmethod
    def from_dict(cls, doc: dict) -> "BufferPlan":
        return cls(impl=dict(doc.get("impl", {})),
                   fifo_depth={k: int(v)
                               for k, v in doc.get("fifo_depth", {}).items()},
                   reasons=dict(doc.get("reasons", {})),
                   vmem_bytes=int(doc.get("vmem_bytes", 0)),
                   hbm_bytes=int(doc.get("hbm_bytes", 0)))


def _fifo_depth(graph: DataflowGraph, buffer: str) -> int:
    """In-flight elements between producer emit and consumer consume.

    For a plain streaming edge a small constant suffices; when the consumer
    keeps a line buffer the skew is (kh-1) rows + a window, which is the
    reuse buffer's own storage — the FIFO proper still only needs the
    constant slack.  We charge the reuse storage to the task (reuse.py),
    and the FIFO with a depth-2 double slot, matching HLS's default
    ``fifo_depth=2`` plus retiming slack.
    """
    del graph, buffer
    return 4


def determine_buffers(graph: DataflowGraph) -> BufferPlan:
    plan = BufferPlan()
    for buf in graph.buffers.values():
        if buf.kind in ("input", "weight"):
            continue
        prods = graph.producers(buf.name)
        cons = graph.consumers(buf.name)
        if not prods or not cons:
            # graph boundary (model output): stays an off-chip stream
            if buf.kind == "intermediate":
                plan.impl[buf.name] = FIFO
                plan.fifo_depth[buf.name] = _fifo_depth(graph, buf.name)
                plan.reasons[buf.name] = "boundary stream"
            continue
        if len(prods) > 1 or len(cons) > 1:
            # coarse violation survived (pass disabled in ablation):
            # dataflow between these tasks is invalid -> block semantics.
            plan.impl[buf.name] = PINGPONG
            plan.reasons[buf.name] = "unresolved coarse violation"
            plan.hbm_bytes += 2 * buf.nbytes
            continue
        vs = fine_violations_edge(graph, prods[0], buf.name, cons[0])
        if vs:
            plan.impl[buf.name] = PINGPONG
            plan.reasons[buf.name] = f"fine violations: {[v.kind for v in vs]}"
            plan.hbm_bytes += 2 * buf.nbytes
        else:
            depth = _fifo_depth(graph, buf.name)
            plan.impl[buf.name] = FIFO
            plan.fifo_depth[buf.name] = depth
            plan.reasons[buf.name] = "fifo-compatible"
            plan.vmem_bytes += depth * np.dtype(buf.dtype).itemsize
        buf.impl = plan.impl[buf.name]
        buf.fifo_depth = plan.fifo_depth.get(buf.name, 0)
    # reuse buffers (line/window) are VMEM residents too
    for t in graph.tasks:
        for shape in t.reuse_buffers.values():
            plan.vmem_bytes += int(np.prod(shape)) * 4
    return plan


def downgrade_to_pingpong(graph: DataflowGraph, plan: BufferPlan, buffer: str,
                          reason: str) -> None:
    """Inter-task conflict resolution (§VI): keep the upstream FIFO chain,
    demote this edge to ping-pong."""
    if plan.impl.get(buffer) == FIFO:
        plan.vmem_bytes -= plan.fifo_depth.get(buffer, 0) * np.dtype(
            graph.buffers[buffer].dtype).itemsize
        plan.fifo_depth.pop(buffer, None)
    plan.impl[buffer] = PINGPONG
    plan.reasons[buffer] = reason
    plan.hbm_bytes += 2 * graph.buffers[buffer].nbytes
    graph.buffers[buffer].impl = PINGPONG
    graph.buffers[buffer].fifo_depth = 0
