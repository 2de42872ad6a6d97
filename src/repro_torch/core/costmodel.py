"""Profiling-based performance model (paper §VI "Stage One", refs [43][48]),
re-parameterized for TPU v5e.

The paper profiles basic operators (adders, MACs) and estimates each loop's
latency from trip counts × parallelism.  We keep exactly that structure —
an op-level initiation-interval (II) table plus trip-count arithmetic — but
the resource vector becomes (compute units ≈ MXU/VPU lane groups, VMEM
bytes, HBM bytes/s per channel) instead of (DSP, BRAM, LUT, FF).

Latencies are reported in *cycles at the nominal TPU clock* so the
benchmark tables can mirror the paper's cycle counts, and in seconds for
the roofline cross-check.

The dataflow-graph latency evaluator implements Fig. 1/Fig. 2 semantics:

* FIFO edge — the consumer starts as soon as its first required element
  arrives: producer start + first-emit skew (+ line-buffer fill for
  stencil consumers).  Delayed FIFO writes (Fig. 2 Issue 2: un-rewritten
  reductions emit at ~8/9 of the iteration space) show up here directly.
* Ping-pong edge — the consumer waits for the producer's whole block.
* Sequential (unresolved coarse violation) — no overlap at all.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .buffers import BufferPlan
from .graph import FIFO, PINGPONG, DataflowGraph, Task
from .patterns import index_dims, reduction_dims

# --------------------------------------------------------------------------
# Hardware parameters (TPU v5e)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class HwParams:
    name: str = "tpu-v5e"
    clock_hz: float = 940e6            # nominal core clock
    peak_flops: float = 197e12         # bf16
    hbm_bw: float = 819e9              # bytes/s
    ici_bw: float = 50e9               # bytes/s per link
    vmem_bytes: int = 128 * 2**20
    hbm_channels: int = 8
    # "compute units": lane-groups the scheduler allocates, the DSP-budget
    # analogue.  One unit retires `unit_flops_per_cycle` flops per cycle.
    max_units: int = 2048
    unit_flops_per_cycle: float = 2.0  # 1 MAC / unit / cycle

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw / self.clock_hz

    @property
    def channel_bytes_per_cycle(self) -> float:
        return self.hbm_bytes_per_cycle / self.hbm_channels


V5E = HwParams()

# NVIDIA H100 SXM5 (data sheet / Hopper white paper): 132 SMs x 128 fp32
# lanes = 16,896 "units" retiring one FMA a cycle at the 1.98 GHz boost
# clock (66.9 TFLOP/s fp32); peak_flops is the dense bf16 tensor-core rate,
# as V5E's is; shared memory per block in the VMEM slot; NVLink's 450 GB/s
# each way in the ICI slot; five HBM3 stacks on ten memory controllers.
# The compiler's defaults stay V5E, so modeled cycles match the reference.
H100 = HwParams(name="h100-sxm", clock_hz=1.98e9, peak_flops=989e12,
                hbm_bw=3.35e12, ici_bw=450e9, vmem_bytes=227 * 1024,
                hbm_channels=10, max_units=16896, unit_flops_per_cycle=2.0)

# Op-level initiation intervals (cycles per innermost iteration at degree 1)
# — the "profiled basic operation" table of §VI.
OP_II: dict[str, float] = {
    "conv": 1.0, "matmul": 1.0, "ewise": 1.0, "pad": 1.0, "copy": 1.0,
    "pool": 1.0, "reduce": 1.0, "norm": 2.0, "softmax": 4.0, "exp": 4.0,
    "generic": 1.0,
}

# Extra pipeline depth (fill) per op — constant, small.
OP_DEPTH: dict[str, float] = {"softmax": 24.0, "norm": 12.0}


# --------------------------------------------------------------------------
# Per-task cost
# --------------------------------------------------------------------------


@dataclass
class TaskCost:
    task: str
    compute_cycles: float
    memory_cycles: float
    latency: float          # max(compute, memory) + depth
    first_emit: float       # cycles until first FIFO write is available
    degree: int             # total parallel degree (product over loops)
    units: int              # compute units consumed
    vmem_bytes: int         # reuse buffers + accumulators

    @property
    def bound(self) -> str:
        return "compute" if self.compute_cycles >= self.memory_cycles else "memory"


def task_degree(task: Task) -> int:
    d = 1
    for l in task.loops:
        d *= max(1, l.parallel)
    return d


def _offchip_read_bytes(graph: DataflowGraph, task: Task) -> dict[int, float]:
    """bytes per HBM channel this task pulls from off-chip (inputs, weights,
    ping-pong intermediates)."""
    per_ch: dict[int, float] = {}
    for a in task.reads:
        buf = graph.buffers[a.buffer]
        off = buf.kind in ("input", "weight") or buf.impl == PINGPONG
        if not off:
            continue
        from .patterns import access_sig
        sig = access_sig(task, a)
        # after reuse rewriting reads are exact-once; otherwise each re-read
        # really hits memory
        elems = min(sig.total, max(sig.distinct, 1)) if "reuse-rewritten" in task.tags \
            or a.enclosing is not None else sig.total
        nbytes = elems * np.dtype(buf.dtype).itemsize
        burst_eff = 1.0
        if buf.burst_len:
            burst_eff = buf.burst_len / (buf.burst_len + 32)
        ch = buf.hbm_channel if buf.hbm_channel >= 0 else 0
        per_ch[ch] = per_ch.get(ch, 0.0) + nbytes / burst_eff
    for a in task.writes:
        buf = graph.buffers[a.buffer]
        if buf.kind == "output" or buf.impl == PINGPONG:
            ch = buf.hbm_channel if buf.hbm_channel >= 0 else 0
            per_ch[ch] = per_ch.get(ch, 0.0) + buf.nbytes
    return per_ch


def task_cost(graph: DataflowGraph, task: Task, hw: HwParams = V5E) -> TaskCost:
    ii = OP_II.get(task.op, 1.0)
    degree = task_degree(task)
    iters = task.total_iters
    compute = iters * ii / degree + OP_DEPTH.get(task.op, 0.0)

    per_ch = _offchip_read_bytes(graph, task)
    memory = max(per_ch.values()) / hw.channel_bytes_per_cycle if per_ch else 0.0

    latency = max(compute, memory) + sum(l.trip for l in task.loops[:2]) * 0.0

    # first-emit skew: how far into the iteration space the first FIFO write
    # lands.  Early (rewritten) writes emit after one reduction window;
    # un-rewritten reductions emit at the end of the innermost index sweep —
    # Fig. 2 Issue 2's "8/9 of iterations" penalty falls out of this.
    first = latency  # default: block semantics
    if task.writes:
        w = task.writes[0]
        red = reduction_dims(task, w)
        red_iters = int(np.prod([task.loop(v).trip for v in red])) if red else 1
        if w.enclosing is not None or not red:
            # rewritten (or naturally streaming): first element after one
            # reduction window at the current degree
            first = red_iters * ii / degree + OP_DEPTH.get(task.op, 0.0)
        else:
            # write still inside reduction: last-minute emission — the
            # consumer effectively waits for almost the whole task
            idx_iters = int(np.prod([task.loop(v).trip for v in index_dims(task, w)]))
            first = latency * (1.0 - 1.0 / max(idx_iters, 1))
    vmem = sum(int(np.prod(s)) * 4 for s in task.reuse_buffers.values())
    return TaskCost(task.name, compute, memory, latency, min(first, latency),
                    degree, degree, vmem)


# --------------------------------------------------------------------------
# Graph latency (dataflow schedule evaluation, Fig. 1/2 semantics)
# --------------------------------------------------------------------------


@dataclass
class GraphCost:
    total_cycles: float
    start: dict[str, float]
    finish: dict[str, float]
    costs: dict[str, TaskCost]
    bottleneck: str
    units: int
    vmem_bytes: int
    seconds: float = 0.0

    def summary(self) -> str:
        return (f"latency={self.total_cycles:,.0f} cycles ({self.seconds*1e3:.3f} ms), "
                f"bottleneck={self.bottleneck}, units={self.units}, "
                f"vmem={self.vmem_bytes/2**20:.2f} MiB")


def _num_blocks(task: Task) -> int:
    """Ping-pong block count: iterations of the outermost varying loop."""
    for l in task.loops:
        if l.trip > 1:
            return l.trip
    return 1


def _stencil_fill(task: Task, cost: TaskCost) -> float:
    """Line-buffer fill delay before a stencil consumer can start: kh-1 rows."""
    for name, shape in task.reuse_buffers.items():
        if name.startswith("lb_") and len(shape) == 3:
            ci, khm1, row = shape
            return ci * khm1 * row  # one cycle per element at arrival rate
    return 0.0


def graph_latency(graph: DataflowGraph, hw: HwParams = V5E,
                  plan: BufferPlan | None = None,
                  sequential: bool = False) -> GraphCost:
    costs = {t.name: task_cost(graph, t, hw) for t in graph.tasks}
    order = graph.toposort()
    start: dict[str, float] = {}
    finish: dict[str, float] = {}
    impl = plan.impl if plan is not None else {
        b.name: b.impl for b in graph.buffers.values()}

    for t in order:
        c = costs[t.name]
        ready = 0.0
        for a in t.reads:
            buf = graph.buffers[a.buffer]
            prods = graph.producers(a.buffer)
            if not prods:
                continue
            p = prods[0]
            pc, pf, ps = costs[p.name], finish[p.name], start[p.name]
            if sequential:
                ready = max(ready, pf)
            elif impl.get(a.buffer) == FIFO:
                skew = ps + pc.first_emit + _stencil_fill(t, c)
                ready = max(ready, skew)
            else:
                # ping-pong: blocks alternate at the producer's outermost
                # varying-loop granularity (Fig. 1(b)/Fig. 2(c)); the
                # consumer starts once the first block lands.
                ready = max(ready, ps + pc.latency / _num_blocks(p))
        start[t.name] = ready
        # steady state: a streaming consumer cannot finish before its
        # producers finish feeding it (rate matching), plus the drain of
        # its last block/element.
        drain = 0.0
        for a in t.reads:
            for p in graph.producers(a.buffer):
                if impl.get(a.buffer) == FIFO:
                    tail = c.latency / max(t.total_iters, 1)
                else:
                    tail = c.latency / _num_blocks(t)
                drain = max(drain, finish[p.name] + tail)
        finish[t.name] = max(ready + c.latency, drain)

    total = max(finish.values()) if finish else 0.0
    bottleneck = max(costs.values(), key=lambda c: c.latency).task if costs else ""
    units = sum(c.units for c in costs.values())
    vmem = sum(c.vmem_bytes for c in costs.values())
    if plan is not None:
        vmem += plan.vmem_bytes
    return GraphCost(total, start, finish, costs, bottleneck, units, vmem,
                     seconds=total / hw.clock_hz)


def sequential_latency(graph: DataflowGraph, hw: HwParams = V5E) -> GraphCost:
    """The Vitis-HLS-baseline analogue: every task at degree 1, no overlap."""
    g = graph.copy()
    for t in g.tasks:
        for l in t.loops:
            l.parallel = 1
    return graph_latency(g, hw, sequential=True)


# --------------------------------------------------------------------------
# Routing predictor: routed-kernel vs generic-XLA latency per
# pattern-matched chain.  Same II/trip-count arithmetic as above, plus a
# small per-backend parameter vector calibrated from the measured routing
# bench (results/bench/routing_groups.json).
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RoutingCostParams:
    """Calibration constants the routing gate combines with structural
    :func:`task_cost` cycles.

    ``efficiency[pattern]`` is the kernel's measured throughput relative
    to the generic path for same-shaped work (geomean of bench speedups —
    1.0 means parity).  ``generic_spill``/``stream_overlap`` model what
    the kernel *structurally* changes: on TPU the generic path bounces
    chain interiors through HBM (spill=1) while the kernel pipelines
    stages (overlap=1); on CPU hosts both sides are one XLA:CPU fusion,
    so neither effect materializes and only the calibrated efficiency and
    the per-kernel dispatch overhead separate them.
    """

    backend: str = "cpu"
    efficiency: tuple[tuple[str, float], ...] = ()
    default_efficiency: float = 1.0
    overhead_cycles: float = 2600.0    # per-kernel dispatch/setup
    generic_spill: float = 0.0         # fraction of interior HBM round-trip
    stream_overlap: float = 0.0        # 0 = stages run back-to-back
    slack: float = 0.02                # noise band: route down to this loss

    def eff(self, pattern: str) -> float:
        return dict(self.efficiency).get(pattern, self.default_efficiency)

    def digest(self) -> str:
        import hashlib
        canon = (self.backend, tuple(sorted(self.efficiency)),
                 self.default_efficiency, self.overhead_cycles,
                 self.generic_spill, self.stream_overlap, self.slack)
        return hashlib.sha256(repr(canon).encode()).hexdigest()[:16]


# Defaults calibrated from the recorded CPU routing bench (nightly
# routing_groups.json; see calibrate_routing_params): conv chains sit at
# ~0.99x parity, mmchains at parity, and the softmaxmm tail measures 0.97x
# — below the slack band, so the gate routes it to generic XLA on CPU.
_CPU_PARAMS = RoutingCostParams(
    backend="cpu",
    efficiency=(("streamfuse.conv", 0.99), ("streamfuse.mmchain", 1.0),
                ("streamfuse.softmaxmm", 0.97),
                # Backward matmul + gradient-epilogue chains measure just
                # under parity on CPU (the epilogue replays registry impls);
                # the gate keeps them generic here — CI forces them on with
                # CODO_FORCE_PALLAS to exercise the kernel path.
                ("streamfuse.mmgrad", 0.98),
                # flashattn's CPU reference is the same fused-jnp chain, so
                # parity; chunked-scan references re-execute the recurrence
                # sequentially and measure slightly under parity — below the
                # slack band, so scans stay generic on CPU unless forced.
                ("flashattn.mha", 1.0), ("rglru.scan", 0.9),
                ("ssd.scan", 0.9)))
DEFAULT_ROUTING_PARAMS: dict[str, RoutingCostParams] = {
    "cpu": _CPU_PARAMS,
    # GPU hosts run the same fused-jnp reference path as CPU.
    "gpu": RoutingCostParams(backend="gpu",
                             efficiency=_CPU_PARAMS.efficiency),
    # Hand-written Hopper kernels: each efficiency is
    # calibrate_routing_params of the autotune records (generic/routed
    # walls of each chain's two forms captured into CUDA graphs, as a
    # jit=True program runs them) of every chain chip_smoke.py's paths
    # match, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).  rglru's
    # clamps at 2.0 (its generic body loops over time); ssd, the conv and
    # the backward epilogues win; the softmax tail is at parity; flash
    # and the chain lose to cuBLAS and fused elementwise at these shapes,
    # so the gate declines them.  No record shows a spill or an overlap
    # the walls do not hold.
    "cuda": RoutingCostParams(
        backend="cuda",
        efficiency=(("flashattn.mha", 0.7781331485414269),
                    ("rglru.scan", 2.0), ("ssd.scan", 1.7444168734491312),
                    ("streamfuse.conv", 1.3358906325023219),
                    ("streamfuse.mmchain", 0.864513985522059),
                    ("streamfuse.mmgrad", 1.2131556927122453),
                    ("streamfuse.softmaxmm", 1.0258204971181324))),
    # On TPU the kernel is the real Pallas implementation: stages pipeline
    # through VMEM (overlap=1) and the generic path pays the interior HBM
    # round-trips (spill=1) — the paper's §VII-C win.  The attention and
    # chunked-scan kernels additionally beat the generic path on *work*:
    # flashattn never materializes the S×S score matrix and the chunked
    # scans trade O(S) sequential steps for O(S/chunk) (§VII-C, Table VI).
    "tpu": RoutingCostParams(backend="tpu", generic_spill=1.0,
                             stream_overlap=1.0, slack=0.0,
                             efficiency=(("flashattn.mha", 1.3),
                                         ("rglru.scan", 1.5),
                                         ("ssd.scan", 1.5))),
}


def routing_backend(device=None) -> str:
    """The backend the routing gate prices against: ``CODO_BACKEND`` when
    set, else ``"cuda"`` for a program whose device is CUDA, else
    ``"cpu"``.  ``device`` is a ``torch.device`` or its string form."""
    import os
    env = os.environ.get("CODO_BACKEND", "").strip().lower()
    if env:
        return env
    return "cuda" if str(device or "cpu").startswith("cuda") else "cpu"


def calibrate_routing_params(doc: dict,
                             base: RoutingCostParams | None = None,
                             ) -> RoutingCostParams:
    """Fit per-pattern efficiency from a ``routing_groups.json`` document:
    the geomean of each pattern's measured ``speedup`` (xla_ms/pallas_ms),
    clamped to a sane band.  Everything else comes from ``base`` (defaults
    for the document's backend)."""
    from dataclasses import replace
    backend = str(doc.get("backend", "cpu"))
    if base is None:
        base = DEFAULT_ROUTING_PARAMS.get(
            backend, replace(_CPU_PARAMS, backend=backend))
    logs: dict[str, list[float]] = {}
    for r in doc.get("records", ()):
        s = float(r.get("speedup", 0.0) or 0.0)
        if s > 0:
            logs.setdefault(str(r.get("kernel", "?")), []).append(np.log(s))
    eff = dict(base.efficiency)
    for pat, ls in logs.items():
        eff[pat] = float(np.clip(np.exp(np.mean(ls)), 0.5, 2.0))
    return replace(base, backend=backend,
                   efficiency=tuple(sorted(eff.items())))


_CALIBRATION_CACHE: dict[str, RoutingCostParams] = {}


def routing_params(backend: str | None = None) -> RoutingCostParams:
    """Active gate parameters: defaults for ``backend`` (detected when
    ``None``), recalibrated from the ``CODO_ROUTING_CALIBRATION`` bench
    JSON when that points at a readable document for the same backend."""
    import json
    import os
    from dataclasses import replace
    backend = backend or routing_backend()
    base = DEFAULT_ROUTING_PARAMS.get(
        backend, replace(_CPU_PARAMS, backend=backend))
    path = os.environ.get("CODO_ROUTING_CALIBRATION", "").strip()
    if not path:
        return base
    key = f"{path}:{backend}"
    hit = _CALIBRATION_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        doc = json.loads(open(path).read())
    except (OSError, ValueError):
        return base
    if str(doc.get("backend", backend)) != backend:
        params = base
    else:
        params = calibrate_routing_params(doc, base)
    _CALIBRATION_CACHE[key] = params
    return params


@dataclass(frozen=True)
class ChainEstimate:
    """Predicted latency of one pattern-matched chain both ways."""

    pattern: str
    tasks: tuple[str, ...]
    routed_cycles: float
    generic_cycles: float
    win: bool

    @property
    def predicted_speedup(self) -> float:
        return self.generic_cycles / max(self.routed_cycles, 1e-9)


def estimate_chain(graph: DataflowGraph, tasks: list[Task],
                   pattern: str, hw: HwParams = V5E,
                   params: RoutingCostParams | None = None) -> ChainEstimate:
    """Price a matched chain both ways with :func:`task_cost` cycles.

    generic = sum of stage latencies + the interior HBM round-trips the
    un-routed path materializes (backend-scaled); routed = the pipelined
    stage latencies at the kernel's calibrated efficiency plus a fixed
    dispatch overhead.  The gate routes iff routed is predicted no slower
    than generic beyond the noise band (``params.slack``).
    """
    if params is None:
        params = routing_params()
    costs = [task_cost(graph, t, hw) for t in tasks]
    total = sum(c.latency for c in costs)
    peak = max(c.latency for c in costs)
    interior_bytes = 0
    for t in tasks[:-1]:
        outs = {a.buffer for a in t.writes}
        for b in outs:
            interior_bytes += graph.buffers[b].nbytes
    spill = (2.0 * interior_bytes / hw.hbm_bytes_per_cycle
             * params.generic_spill)               # write + re-read
    generic = total + spill
    pipelined = total - params.stream_overlap * (total - peak)
    routed = pipelined / params.eff(pattern) + params.overhead_cycles
    win = routed <= generic * (1.0 + params.slack)
    return ChainEstimate(pattern, tuple(t.name for t in tasks),
                         routed, generic, win)


# --------------------------------------------------------------------------
# Sharding: compute-per-shard vs link bytes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingEstimate:
    """Per-device cost of one sharding candidate: the compute each device
    actually runs (task latency divided by its shard factor) plus the
    cycles its collective schedule spends on the inter-chip links."""

    strategy: str
    compute_cycles: float
    collective_cycles: float
    collective_bytes: int

    @property
    def total_cycles(self) -> float:
        return self.compute_cycles + self.collective_cycles


# Bytes each device moves per payload byte, per collective algorithm
# (the classic ring-algorithm link factors).
_LINK_FACTOR = {
    ("psum", "direct"): 2.0,          # all-reduce: reduce + broadcast
    ("psum", "rs_ag"): 2.0,           # 2(n-1)/n ~ 2, bandwidth-optimal
    ("all_gather", "direct"): 1.0,    # (n-1)/n ~ 1
    ("all_gather", "ring"): 1.0,
    ("reduce_scatter", "direct"): 1.0,
    ("ppermute", "direct"): 1.0,
}


def estimate_sharding(graph: DataflowGraph, plan, hw: HwParams = V5E):
    """Price a :class:`~repro.distributed.plan.ShardingPlan`.

    Compute: every task's single-device latency shrinks by the product of
    mesh-axis sizes sharding its output (a psum emitted after the task
    means its contraction was sharded too, so that axis also divides the
    work).  Collectives: payload bytes x the algorithm's link factor over
    the ICI bandwidth, expressed in core cycles so the two sides add.
    """
    psum_after: dict[str, set] = {}
    for s in plan.steps:
        if s.kind == "psum" and s.where == "after":
            psum_after.setdefault(s.task, set()).add(s.axis)

    compute = 0.0
    for task in graph.tasks:
        cost = task_cost(graph, task, hw)
        axes: set = set(psum_after.get(task.name, set()))
        for a in task.writes:
            spec = plan.spec_of(a.buffer, len(graph.buffers[a.buffer].shape))
            axes.update(d for d in spec.dims if d is not None)
        factor = 1
        for ax in axes:
            factor *= plan.mesh.axis_size(ax)
        compute += cost.latency / max(factor, 1)

    link_bps = max(hw.ici_bw, 1.0)
    bytes_per_cycle = link_bps / hw.clock_hz
    coll = 0.0
    total_bytes = 0
    for s in plan.steps:
        factor = _LINK_FACTOR.get((s.kind, s.via), 1.0)
        n = plan.mesh.axis_size(s.axis)
        if n <= 1:
            continue
        coll += s.bytes * factor / bytes_per_cycle
        total_bytes += s.bytes
    return ShardingEstimate(strategy=plan.strategy, compute_cycles=compute,
                            collective_cycles=coll,
                            collective_bytes=total_bytes)
