"""Access-pattern analysis and dataflow-violation detection (paper §II-A/§IV).

Two violation classes:

*Coarse-grained* — a buffer breaks the single-producer-single-consumer rule
(SPMC / MPSC / MPMC patterns of Fig. 4).

*Fine-grained* — producer/consumer access count or order mismatch, which on
an FPGA FIFO means overflow/underflow/deadlock and on TPU means the two
tasks cannot be fused into one streaming kernel (their tile streams would
disagree).  Detected statically from the affine signatures — this replaces
the paper's days-long co-simulation with a compile-time check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import Access, DataflowGraph, Task

# Coarse violation kinds (Fig. 4 a/b/c)
SPMC = "single-producer-multi-consumer"
MPSC = "multi-producer-single-consumer"
MPMC = "multi-producer-multi-consumer"

# Fine violation kinds (§II-C, Fig. 2 Issue 1)
COUNT_MISMATCH = "access-count-mismatch"
ORDER_MISMATCH = "access-order-mismatch"
STENCIL_REREAD = "stencil-multi-read"       # consumer re-reads via a sliding window
BROADCAST_REREAD = "broadcast-re-read"      # consumer re-reads across a reduction dim
MULTI_WRITE = "reduction-multi-write"       # producer writes each element >1× (reduction)


@dataclass
class CoarseViolation:
    buffer: str
    kind: str
    producers: list[str]
    consumers: list[str]


@dataclass
class FineViolation:
    buffer: str
    kind: str
    producer: str
    consumer: str
    detail: str = ""


# --------------------------------------------------------------------------
# Per-access signature
# --------------------------------------------------------------------------


@dataclass
class AccessSig:
    """Streaming signature of one access inside one task."""

    task: str
    buffer: str
    is_write: bool
    dim_depth: tuple[int, ...]   # array-dim -> loop depth of its driving var
    dim_order: tuple[int, ...]   # array dims sorted by variation rate (outer first)
    distinct: int                # distinct elements touched
    total: int                   # total dynamic access count
    window: bool                 # overlapping multi-var dims (stencil window)
    index_vars: frozenset[str] = field(default_factory=frozenset)

    @property
    def repeats(self) -> bool:
        return self.total > self.distinct


def _dim_span(dim, trips) -> int:
    """Extent of values an affine index expression takes: sum_i (trip_i-1)*s_i + 1."""
    if not dim:
        return 1
    span = 1
    for v, s in dim:
        span += (trips[v] - 1) * abs(s)
    return span


def _dim_combos(dim, trips) -> int:
    """Number of (var...) combinations driving this dim."""
    c = 1
    for v, _s in dim:
        c *= trips[v]
    return c


def access_sig(task: Task, access: Access) -> AccessSig:
    enclosing = task.enclosing_vars(access)
    trips = {l.var: l.trip for l in task.loops}

    if access.stream_shape is not None:
        # Reuse-rewritten load region: exact-once stream over the stated
        # logical extent, ordered by the current index drivers.
        dim_depth = []
        for dim in access.index:
            ds = [task.loop_depth(v) for (v, _s) in dim if task.has_loop(v)]
            dim_depth.append(min(ds) if ds else len(task.loops))
        dim_order = tuple(int(i) for i in np.argsort(np.array(dim_depth), kind="stable"))
        distinct = int(np.prod([s for s in access.stream_shape])) \
            if access.stream_shape else 1
        return AccessSig(
            task=task.name, buffer=access.buffer, is_write=access.is_write,
            dim_depth=tuple(dim_depth), dim_order=dim_order,
            distinct=distinct, total=distinct, window=False,
            index_vars=frozenset(v for dim in access.index for (v, _s) in dim))

    window = False
    dim_depth = []
    distinct = 1
    for dim in access.index:
        live = [(v, s) for (v, s) in dim if trips.get(v, 1) > 1]
        if len(live) > 1:
            combos = _dim_combos(live, trips)
            span = _dim_span(live, trips)
            if combos > span:
                window = True        # overlapping window (conv);  stride-k pool is exact
            distinct *= span
        else:
            distinct *= _dim_span(live, trips)
        ds = [task.loop_depth(v) for (v, _s) in dim if task.has_loop(v)]
        dim_depth.append(min(ds) if ds else len(task.loops))
    dim_order = tuple(int(i) for i in np.argsort(np.array(dim_depth), kind="stable"))

    total = task.trip_product(enclosing)
    index_vars = frozenset(v for dim in access.index for (v, _s) in dim)
    return AccessSig(
        task=task.name,
        buffer=access.buffer,
        is_write=access.is_write,
        dim_depth=tuple(dim_depth),
        dim_order=dim_order,
        distinct=distinct,
        total=total,
        window=window,
        index_vars=index_vars,
    )


def index_dims(task: Task, access: Access) -> list[str]:
    """Loop vars that appear in the access index, in loop order."""
    vars_ = access.vars()
    return [l.var for l in task.loops if l.var in vars_]


def reduction_dims(task: Task, access: Access) -> list[str]:
    """Loop vars enclosing the access that do NOT appear in its index —
    the 'reduction dimensions' of §IV-B."""
    vars_ = access.vars()
    return [v for v in task.enclosing_vars(access) if v not in vars_]


def arrival_order(task: Task, access: Access) -> tuple[int, ...]:
    """Array dims in their stream-arrival order (outermost driver first),
    considering only dims that actually vary."""
    trips = {l.var: l.trip for l in task.loops}
    varying = []
    for i, dim in enumerate(access.index):
        live = [v for (v, _s) in dim if trips.get(v, 1) > 1]
        if live:
            d = min(task.loop_depth(v) for v in live if task.has_loop(v))
            varying.append((d, i))
    varying.sort()
    return tuple(i for (_d, i) in varying)


# --------------------------------------------------------------------------
# Coarse-grained detection (Fig. 4)
# --------------------------------------------------------------------------


def coarse_violations(graph: DataflowGraph) -> list[CoarseViolation]:
    out = []
    for buf in graph.buffers.values():
        if buf.kind in ("input", "weight"):
            # External inputs may fan out freely: duplication happens at the
            # off-chip boundary (each consumer DMAs its own stream).
            continue
        prods = graph.producers(buf.name)
        cons = graph.consumers(buf.name)
        np_, nc = len(prods), len(cons)
        if np_ <= 1 and nc <= 1:
            continue
        kind = SPMC if np_ <= 1 else (MPSC if nc <= 1 else MPMC)
        out.append(CoarseViolation(buf.name, kind, [t.name for t in prods],
                                   [t.name for t in cons]))
    return out


# --------------------------------------------------------------------------
# Fine-grained detection (§IV-B)
# --------------------------------------------------------------------------


def fine_violations_edge(graph: DataflowGraph, producer: Task, buffer: str,
                         consumer: Task) -> list[FineViolation]:
    """All fine-grained violations on one producer→consumer edge."""
    out: list[FineViolation] = []
    w = producer.writes_to(buffer)
    r = consumer.reads_from(buffer)
    if not w or not r:
        return out
    ws, rs = access_sig(producer, w[0]), access_sig(consumer, r[0])

    if ws.repeats:
        out.append(FineViolation(
            buffer, MULTI_WRITE, producer.name, consumer.name,
            f"producer writes {ws.total}x for {ws.distinct} elements "
            f"(reduction dims {reduction_dims(producer, w[0])})"))
    if rs.window:
        out.append(FineViolation(
            buffer, STENCIL_REREAD, producer.name, consumer.name,
            "consumer reads an overlapping window (line/window reuse buffer required)"))
    elif rs.repeats:
        out.append(FineViolation(
            buffer, BROADCAST_REREAD, producer.name, consumer.name,
            f"reads {rs.total}x for {rs.distinct} elements "
            f"(reduction dims {reduction_dims(consumer, r[0])})"))
    if not ws.repeats and not rs.repeats and not rs.window:
        if ws.distinct != rs.distinct:
            out.append(FineViolation(
                buffer, COUNT_MISMATCH, producer.name, consumer.name,
                f"writes {ws.distinct} != reads {rs.distinct}"))
        elif arrival_order(producer, w[0]) != arrival_order(consumer, r[0]):
            out.append(FineViolation(
                buffer, ORDER_MISMATCH, producer.name, consumer.name,
                f"write order {arrival_order(producer, w[0])} != "
                f"read order {arrival_order(consumer, r[0])}"))
    return out


def fine_violations(graph: DataflowGraph) -> list[FineViolation]:
    out = []
    for p, buf, c in graph.internal_edges():
        out.extend(fine_violations_edge(graph, p, buf, c))
    return out


def edge_is_fifo_compatible(graph: DataflowGraph, producer: Task, buffer: str,
                            consumer: Task) -> bool:
    return not fine_violations_edge(graph, producer, buffer, consumer)


def violation_report(graph: DataflowGraph) -> str:
    cs, fs = coarse_violations(graph), fine_violations(graph)
    lines = [f"{graph.name}: {len(cs)} coarse, {len(fs)} fine violations"]
    for v in cs:
        lines.append(f"  [coarse/{v.kind}] {v.buffer}: {v.producers} -> {v.consumers}")
    for v in fs:
        lines.append(f"  [fine/{v.kind}] {v.buffer}: {v.producer} -> {v.consumer}: {v.detail}")
    return "\n".join(lines)
