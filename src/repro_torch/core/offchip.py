"""Off-chip data-transfer management (paper §V-C), re-targeted to TPU HBM.

The paper stripes weights across U280 HBM pseudo-channels and emits burst
accesses.  On TPU there are no user-visible channels, but the same two
levers exist:

* **burst length** → contiguous innermost extent of each DMA.  We plan
  layouts so the last dim is lane-aligned (multiple of 128) and compute the
  achievable burst per buffer; short bursts get flagged with a padded
  layout plan.
* **channel parallelism** → splitting independent weight streams across
  the (8, 16, ...) HBM "channel" queues maps to issuing independent async
  copies (double-buffered prefetch in the Pallas grid): we round-robin
  buffers over ``num_channels`` queues balancing bytes, which becomes the
  prefetch schedule of the lowered kernels.

The resulting plan feeds the cost model's bandwidth-utilization term and
the launch-time host code (launch/*.py prints the transfer manifest).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import DataflowGraph

LANE = 128          # TPU lane width (f32 elements)
SUBLANE = 8

# Pipeline declaration consumed by passes.default_passes().
PASS_INFO = {
    "name": "offchip",
    "result_attr": "transfer_plan",
    "option_flag": "communication",
    "invalidates": (),
    "description": "off-chip transfer management (§V-C: channels + bursts)",
}


@dataclass
class TransferPlan:
    channel_of: dict[str, int] = field(default_factory=dict)
    burst_len: dict[str, int] = field(default_factory=dict)     # elements
    padded_shape: dict[str, tuple] = field(default_factory=dict)
    channel_bytes: list[int] = field(default_factory=list)
    bandwidth_util: float = 0.0

    def summary(self) -> str:
        return (f"offchip: {len(self.channel_of)} buffers over "
                f"{len(self.channel_bytes)} channels, "
                f"bw_util={self.bandwidth_util:.2f}, "
                f"max_channel={max(self.channel_bytes) if self.channel_bytes else 0}B")

    # ---- JSON serialization (docs/artifact_format.md `transfer_plan`) ----
    def to_dict(self) -> dict:
        return {"channel_of": dict(self.channel_of),
                "burst_len": dict(self.burst_len),
                "padded_shape": {k: list(v)
                                 for k, v in self.padded_shape.items()},
                "channel_bytes": list(self.channel_bytes),
                "bandwidth_util": self.bandwidth_util}

    @classmethod
    def from_dict(cls, doc: dict) -> "TransferPlan":
        return cls(
            channel_of={k: int(v) for k, v in doc.get("channel_of", {}).items()},
            burst_len={k: int(v) for k, v in doc.get("burst_len", {}).items()},
            padded_shape={k: tuple(int(s) for s in v)
                          for k, v in doc.get("padded_shape", {}).items()},
            channel_bytes=[int(b) for b in doc.get("channel_bytes", ())],
            bandwidth_util=float(doc.get("bandwidth_util", 0.0)))


def _burst(shape: tuple[int, ...]) -> int:
    """Contiguous innermost extent (elements) of a row-major layout."""
    if not shape:
        return 1
    b = 1
    for d in reversed(shape):
        b *= d
        if d % LANE != 0 and b != int(np.prod(shape)):
            break
    return min(b, int(np.prod(shape)))


def _pad_to_lanes(shape: tuple[int, ...]) -> tuple[int, ...]:
    if not shape:
        return shape
    out = list(shape)
    out[-1] = ((out[-1] + LANE - 1) // LANE) * LANE
    if len(out) >= 2:
        out[-2] = ((out[-2] + SUBLANE - 1) // SUBLANE) * SUBLANE
    return tuple(out)


def plan_offchip(graph: DataflowGraph, num_channels: int = 8,
                 min_burst: int = LANE) -> TransferPlan:
    plan = TransferPlan(channel_bytes=[0] * num_channels)
    offchip = [b for b in graph.buffers.values()
               if b.kind in ("input", "weight", "output")
               or b.impl == "pingpong"]
    # Greedy largest-first balancing over channels (paper: "distributes
    # parameters ... across different HBM channels, enabling parallel
    # access to independent memory regions").
    for buf in sorted(offchip, key=lambda b: -b.nbytes):
        ch = int(np.argmin(plan.channel_bytes))
        plan.channel_of[buf.name] = ch
        plan.channel_bytes[ch] += buf.nbytes
        buf.hbm_channel = ch
        burst = _burst(buf.shape)
        if burst < min_burst:
            plan.padded_shape[buf.name] = _pad_to_lanes(buf.shape)
            burst = _burst(plan.padded_shape[buf.name])
        plan.burst_len[buf.name] = burst
        buf.burst_len = burst

    # Bandwidth utilization estimate: long bursts amortize DMA setup; model
    # eff = burst/(burst+overhead) averaged over bytes, times channel balance.
    total = sum(b.nbytes for b in offchip)
    if total:
        OVERHEAD = 32  # elements of setup per burst (descriptor + latency)
        eff = sum(b.nbytes * (plan.burst_len[b.name]
                              / (plan.burst_len[b.name] + OVERHEAD))
                  for b in offchip) / total
        balance = (total / num_channels) / max(plan.channel_bytes) \
            if max(plan.channel_bytes) else 1.0
        plan.bandwidth_util = eff * min(1.0, balance * num_channels / num_channels)
    return plan


def host_manifest(graph: DataflowGraph, plan: TransferPlan) -> str:
    """The generated 'host code' — a transfer manifest the launcher executes
    (replaces the paper's codo-transmit OpenCL host generation)."""
    lines = ["# transfer manifest (buffer, channel, bytes, burst_elems)"]
    for name, ch in sorted(plan.channel_of.items()):
        b = graph.buffers[name]
        lines.append(f"h2d {name:<28s} ch={ch} bytes={b.nbytes} burst={plan.burst_len[name]}"
                     + (f" padded={plan.padded_shape[name]}" if name in plan.padded_shape else ""))
    return "\n".join(lines)
