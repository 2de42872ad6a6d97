"""Lower inter-device edges to typed collectives and execute them.

The PyTorch port of ``repro/distributed/collectives.py``.  Two halves:

* **Plan construction** (pure data, the reference's code):
  :func:`build_steps` turns the raw events the partitioner emitted into
  sized :class:`~repro_torch.distributed.plan.CollectiveStep` records.
  Buffer sizing reuses the single-device FIFO machinery — a collective
  stages ``depth`` slots (the buffer's FIFO depth) of one ``chunk_bytes``
  chunk each, and inherits the HBM channel the off-chip pass balanced the
  buffer onto.  Decomposition choices are made *here*, from byte counts,
  so an exported plan replays identically:

  - a psum at or above ``CODO_COLLECTIVE_RSAG_BYTES`` becomes
    reduce_scatter + all_gather (``via="rs_ag"``, the bandwidth-optimal
    2(n-1)/n bytes-per-link form) when the leading dim splits evenly;
  - an all_gather at or above ``CODO_COLLECTIVE_RING_BYTES`` becomes a
    ring (``via="ring"``): n-1 neighbour hops of one chunk each instead
    of one n·chunk broadcast.

* **Execution**: :func:`make_collective` turns a step into a function
  from the list of the local shards along ``step.axis`` (one per mesh
  position of the group, in position order) to the list after the
  collective, each result on its own position's device.  The sharded
  lowering (:func:`repro_torch.core.lowering.lower` with ``sharding=``)
  drives every position in lockstep from one process, as ``shard_map``
  under ``jax.jit`` does in the reference, and applies the functions
  :func:`attach` anchors before and after their tasks.  Every form sums
  in position order, so ``rs_ag`` is bit for bit ``direct`` and the ring
  bit for bit the direct all-gather.

* **Group collectives** of the LM stack's lockstep executor
  (:mod:`~repro_torch.distributed.spmd`), which runs the positions of a
  compute unit one after another in one thread: :func:`group_psum`,
  :func:`group_pmax` and :func:`group_all_gather` take the group's values
  in position order and give the one result every position of the group
  holds (a replicated activation is one tensor there), reporting the
  collective to the active cost walker.

* **In-step collectives** for code running under the port's
  :func:`~repro_torch.distributed.sharding.shard_map`:
  :func:`run_positions` runs a function once a mesh position, one thread
  each, and :func:`psum`, :func:`pmax` and :func:`all_gather` over named
  axes are rendezvous of those threads: every position of the group
  leaves its value, and each takes the group's reduction in position
  order (bit for bit :func:`make_collective`'s direct form).

* **Across ranks** (a mesh split over processes,
  :func:`~repro_torch.launch.mesh.rank_mesh`): each rank passes its local
  positions' values, and :func:`exchange` brings the remote ones with one
  ``all_gather`` of equal-shaped tensors over the ranks of the group
  (NCCL on the card, gloo on the CPU).  The arithmetic that follows is
  the single-process form's, in position order on every rank, so every
  result is bit for bit the single-process one.  No sum goes through a
  reducing collective: NCCL's ``all_reduce`` adds in ring order.  The
  plan's ``via`` forms move their bytes through the same ``all_gather``
  for now.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict

from repro_torch.distributed.plan import CollectiveStep, MeshSpec, ShardingPlan

__all__ = ["all_gather", "attach", "build_steps", "charge_backward",
           "env_partition_specs", "exchange", "group_all_gather",
           "group_pmax", "group_psum", "make_collective", "pmax", "psum",
           "run_positions"]

_MIB = 1 << 20


def _threshold(env: str, default: int) -> int:
    try:
        return int(os.environ.get(env, default))
    except ValueError:
        return default


def _depth(graph, name: str, buffer_plan) -> int:
    if buffer_plan is not None:
        d = getattr(buffer_plan, "fifo_depth", {}).get(name)
        if d:
            return int(d)
    from repro_torch.core import buffers as _b
    return int(_b._fifo_depth(graph, graph.buffers[name]))


def build_steps(graph, mesh: MeshSpec, events, *, buffer_plan=None,
                transfer_plan=None) -> tuple[CollectiveStep, ...]:
    """Size and type the raw partitioner events into the plan schedule."""
    ring_at = _threshold("CODO_COLLECTIVE_RING_BYTES", _MIB)
    rsag_at = _threshold("CODO_COLLECTIVE_RSAG_BYTES", _MIB)
    channels = getattr(transfer_plan, "channel_of", None) or {}
    steps = []
    for ev in events:
        buf = graph.buffers[ev["buffer"]]
        n = mesh.axis_size(ev["axis"])
        if ev["kind"] == "all_gather":
            # each device contributes its local shard once per link
            payload = buf.nbytes // n
            chunk = payload
            via = "ring" if (payload * (n - 1) >= ring_at and n > 1) \
                else "direct"
        elif ev["kind"] == "psum":
            payload = buf.nbytes
            chunk = buf.nbytes // n
            via = "rs_ag" if (payload >= rsag_at and n > 1
                              and buf.shape and buf.shape[0] % n == 0) \
                else "direct"
        else:  # pragma: no cover - partitioner only emits the two above
            payload = buf.nbytes
            chunk = buf.nbytes // max(n, 1)
            via = "direct"
        steps.append(CollectiveStep(
            kind=ev["kind"], buffer=ev["buffer"], axis=ev["axis"],
            task=ev["task"], where=ev["where"], dim=int(ev.get("dim", 0)),
            bytes=int(payload), chunk_bytes=int(chunk),
            depth=_depth(graph, ev["buffer"], buffer_plan),
            channel=int(channels.get(ev["buffer"], -1)), via=via))
    return tuple(steps)


# --------------------------------------------------------------------------
# execution: one function over the local shards of a group of positions
# --------------------------------------------------------------------------


def _sum_on(xs: list, device):
    """``xs[0] + xs[1] + ...`` in position order, on ``device``."""
    acc = xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


def _psum(xs: list) -> list:
    total = _sum_on(xs, xs[0].device)
    return [total.to(x.device) for x in xs]


def _reduce_scatter(xs: list) -> list:
    """Position j's result: chunk j of dim 0, summed over the positions in
    order on position j's device."""
    n = len(xs)
    c = xs[0].shape[0] // n
    return [_sum_on([x.narrow(0, j * c, c) for x in xs], xs[j].device)
            for j in range(n)]


def _all_gather(xs: list, dim: int) -> list:
    """Every position's shard concatenated along ``dim`` in position order,
    once for each device the positions sit on."""
    import torch
    full: dict = {}
    for x in xs:
        if x.device not in full:
            full[x.device] = torch.cat([y.to(x.device) for y in xs], dim)
    return [full[x.device] for x in xs]


def _ring_all_gather(xs: list, dim: int) -> list:
    """All-gather as n-1 neighbour hops.

    Each hop moves every position's current chunk to the next position's
    device, so after hop j position i holds the shard of position ``(i -
    j) mod n``; reindexing its slots by ``(i - m) mod n`` restores position
    order before the concatenation, so the result is bit for bit the
    direct all-gather (the reference's ``_ring_all_gather``)."""
    import torch
    n = len(xs)
    slots = [[x] for x in xs]
    cur = list(xs)
    for _ in range(n - 1):
        cur = [cur[(i - 1) % n].to(xs[i].device) for i in range(n)]
        for i in range(n):
            slots[i].append(cur[i])
    return [torch.cat([slots[i][(i - m) % n] for m in range(n)], dim)
            for i in range(n)]


def make_collective(step: CollectiveStep, mesh):
    """One plan step as a function from the list of local shards along
    ``step.axis`` (one group of positions, in position order) to the list
    after the collective.

    Called ``fn(xs, group)``, ``group`` is the group's positions in order
    and ``xs`` the values of this process's positions among them; it
    returns their results.  On a mesh split over ranks the remote values
    come through :func:`exchange`, and the form runs on the whole list as
    it does in one process."""
    n = MeshSpec.of(mesh).axis_size(step.axis)
    if step.kind == "psum":
        form = _psum
        if step.via == "rs_ag" and n > 1:
            def form(xs):
                return _all_gather(_reduce_scatter(xs), 0)
    elif step.kind == "all_gather":
        dim = step.dim
        if step.via == "ring" and n > 1:
            def form(xs):
                return _ring_all_gather(xs, dim)
        else:
            def form(xs):
                return _all_gather(xs, dim)
    else:
        raise ValueError(f"cannot execute collective kind {step.kind!r}")

    def run(xs: list, group: list | None = None) -> list:
        if group is None:
            return form(xs)
        out = form(_across(xs, group, mesh))
        return [y for p, y in zip(group, out) if mesh.is_local(p)]

    return run


# --------------------------------------------------------------------------
# the one primitive across ranks
# --------------------------------------------------------------------------


def exchange(mesh, values: dict, positions, *, ranks=None, like=None,
             rank_of=None) -> list:
    """The values of ``positions`` in that order, on a mesh split over
    ranks: ``values`` holds this rank's positions' (any of ``positions``
    it holds), and the others come from their ranks through one
    ``all_gather`` over the process group of ``ranks`` (by default the
    ranks holding ``positions``; every one of them calls it at the same
    point of its program).  Each rank sends its positions' values stacked
    (equal shapes and dtype), padded to the most any rank holds, moved as
    bytes; a rank that holds none of them sends padding shaped as
    ``like``.  Every value comes back from the received bytes (this
    rank's own too), laid out as ``like`` (:func:`_laid_out`), so what the
    callers compute from them is bit for bit what one process computes,
    and a fault of the transport shows in the results.

    On a single-process mesh, and where this rank holds every position of
    a group of one rank of several, nothing moves.  A mesh of one rank
    moves its values through the group all the same, so that one card
    runs, captures and checks the transport several cards use.  ``rank_of``
    maps a key of ``positions`` to its rank where the keys are not mesh
    positions (the data blocks of a step)."""
    import torch
    import torch.distributed as dist
    positions = list(positions)
    if not mesh.distributed:
        return [values[p] for p in positions]
    rank_of = rank_of or mesh.rank_of
    ranks = tuple(sorted(set(ranks if ranks is not None
                             else (rank_of(p) for p in positions))))
    if ranks == (mesh.rank,) and mesh.world > 1:
        return [values[p] for p in positions]
    held = {r: [p for p in positions if rank_of(p) == r] for r in ranks}
    slots = max(len(ps) for ps in held.values())
    mine = [values[p] for p in held.get(mesh.rank, [])]
    like = mine[0] if mine else like
    if like is None:
        raise ValueError("exchange: this rank holds none of the positions; "
                         "pass like= for its padding")
    pad = [torch.zeros_like(like)] * (slots - len(mine))
    send = torch.stack([*mine, *pad]).contiguous()
    wire = send.view(torch.uint8)
    recv = [torch.empty_like(wire) for _ in ranks]
    dist.all_gather(recv, wire, group=mesh.process_group(ranks))
    got = {}
    for r, buf in zip(ranks, recv):
        buf = buf.view(send.dtype)
        for i, p in enumerate(held[r]):
            got[p] = _laid_out(buf[i], like)
    return [got[p] for p in positions]


def _laid_out(value, like):
    """``value`` (contiguous) in ``like``'s memory layout, where that is
    another dense one: the order a later reduction walks a tensor in
    follows its strides, so a received value must lie as the sender's
    did (every position's value of one collective lies alike) for what is
    computed from it to be bit for bit the single-process result."""
    import torch
    if like.is_contiguous():
        return value
    return torch.empty_like(like).copy_(value)


def attach(steps):
    """Index plan steps by schedule anchor: (before[task], after[task])."""
    before: dict[str, list] = defaultdict(list)
    after: dict[str, list] = defaultdict(list)
    for s in steps:
        (before if s.where == "before" else after)[s.task].append(s)
    return before, after


def env_partition_specs(graph, plan: ShardingPlan):
    """:class:`~repro_torch.distributed.plan.ShardSpec` dicts for the env:
    (inputs+weights, outputs) — how the sharded lowering splits the env
    onto the positions and reassembles the outputs (the reference's
    ``shard_map`` in_specs/out_specs)."""
    def spec(buf):
        return plan.spec_of(buf.name, len(buf.shape))

    ins = {b.name: spec(b) for b in graph.inputs() + graph.weights()}
    outs = {b.name: spec(b) for b in graph.outputs()}
    return ins, outs


# --------------------------------------------------------------------------
# group collectives of the lockstep executor: one thread, the group's values
# in position order, one result
# --------------------------------------------------------------------------


def _charge(op: str, result, group: int) -> None:
    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    if walker is not None:
        walker.collective(op, hlo_analysis.tensor_bytes(result), group,
                          weight=walker.weight)


def charge_backward(op: str, t, group: int) -> None:
    """When autograd computes ``t``'s gradient, charge the walker active
    now, at the share in force now, the collective ``op`` that carries it
    over the group's ``group`` positions: ``"all-reduce"`` of the gradient
    (the sum of the partial gradients of a value the positions all read),
    or ``"reduce-scatter"`` of it into the positions' shards.
    Nothing is charged for a value made inside the backward (a checkpointed
    region's recompute): no gradient flows through it, and an input it
    shares with the first pass already carries that pass's hook."""
    import torch

    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    if (walker is None or group < 2 or not t.requires_grad
            or torch._C._current_autograd_node() is not None):
        return
    weight = walker.weight

    def hook(grad):
        if hlo_analysis.active() is walker:
            nbytes = hlo_analysis.tensor_bytes(grad)
            if op == "reduce-scatter":           # its result: one shard
                nbytes /= group
            walker.collective(op, nbytes, group, weight=weight)

    t.register_hook(hook)


def _across(xs: list, group, mesh) -> list:
    """The group's values in position order: ``xs`` as given on one
    process; on a mesh split over ranks ``xs`` are this rank's positions'
    among ``group`` and the others come through :func:`exchange`."""
    if group is None:
        return xs
    from .sharding import current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    local = [p for p in group if mesh.is_local(p)]
    return exchange(mesh, dict(zip(local, xs)), group)


def group_psum(xs: list, group=None, mesh=None):
    """The sum of the group's values ``xs`` (position order), accumulated
    in float32 in that order and given back in their dtype: an all-reduce
    over the group (bit for bit :func:`psum` for float32 values).  With
    ``group`` (its positions on ``mesh``, the ambient mesh by default)
    ``xs`` are this rank's positions' values and the others come from
    their ranks."""
    xs = _across(xs, group, mesh)
    out = xs[0] if len(xs) == 1 else _sum_on(
        [x.float() for x in xs], xs[0].device).to(xs[0].dtype)
    _charge("all-reduce", out, len(xs))
    return out


def group_pmax(xs: list, group=None, mesh=None):
    """The elementwise maximum of the group's values: an all-reduce
    (``group`` and ``mesh`` as :func:`group_psum` takes them)."""
    import torch
    xs = _across(xs, group, mesh)
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x.to(out.device))
    _charge("all-reduce", out, len(xs))
    return out


def group_all_gather(xs: list, dim: int, group=None, mesh=None):
    """The group's values concatenated along ``dim`` in position order:
    an all-gather over the group (its gradient back to the positions a
    reduce-scatter, as the walker is charged; ``group`` and ``mesh`` as
    :func:`group_psum` takes them)."""
    import torch
    xs = _across(xs, group, mesh)
    out = xs[0] if len(xs) == 1 else torch.cat(
        [x.to(xs[0].device) for x in xs], dim)
    _charge("all-gather", out, len(xs))
    charge_backward("reduce-scatter", out, len(xs))  # its transpose
    return out


# --------------------------------------------------------------------------
# in-step collectives: one thread a position, each collective a rendezvous
# --------------------------------------------------------------------------

_POSITION = threading.local()
# Seconds a position waits at a rendezvous before the run is abandoned (a
# position that never arrives: a collective called on some positions only).
RENDEZVOUS_TIMEOUT_S = 600.0


class _Rendezvous:
    """The shared state of one :func:`run_positions` call: a slot per
    position and a barrier of them all."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.slots: list = [None] * mesh.size
        self.barrier = threading.Barrier(mesh.size,
                                         timeout=RENDEZVOUS_TIMEOUT_S)

    def exchange(self, position: int, value, axes: tuple) -> list:
        """Every position of ``position``'s group along ``axes`` (in
        position order) and their values; all positions must call it."""
        self.slots[position] = value
        self.barrier.wait()
        group = _group_of(self.mesh, position, axes)
        values = [self.slots[q] for q in group]
        self.barrier.wait()             # the slots may be written again
        return values, group.index(position)


def _group_of(mesh, position: int, axes: tuple) -> list:
    """The positions that share every coordinate but those of ``axes``."""
    here = mesh.coords(position)
    return [q for q in range(mesh.size)
            if all(c == here[k] for k, c in mesh.coords(q).items()
                   if k not in axes)]


def run_positions(mesh, fn) -> list:
    """``[fn(0), fn(1), ...]``: ``fn(p)`` run for every position of
    ``mesh``, one thread a position, with :func:`psum` / :func:`pmax` /
    :func:`all_gather` bound to the mesh's axes and the mesh ambient
    (:func:`~repro_torch.distributed.sharding.use_mesh`).  A position that
    raises breaks the barrier, so the others raise too; the first error is
    re-raised here."""
    from .sharding import use_mesh
    rv = _Rendezvous(mesh)
    results: list = [None] * mesh.size
    errors: list = [None] * mesh.size

    def run(p):
        _POSITION.state = (rv, p)
        try:
            with use_mesh(mesh):
                results[p] = fn(p)
        except BaseException as e:          # noqa: BLE001 — re-raised below
            errors[p] = e
            rv.barrier.abort()
        finally:
            _POSITION.state = None

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _exchange(x, axes):
    state = getattr(_POSITION, "state", None)
    if state is None:
        raise NameError(f"unbound axis name {_axes(axes)}: collectives over "
                        f"named axes run inside shard_map")
    rv, p = state
    axes = _axes(axes)
    missing = [a for a in axes if a not in rv.mesh.axis_names]
    if missing:
        raise NameError(f"unbound axis name {missing[0]!r}: the mesh has "
                        f"axes {tuple(rv.mesh.axis_names)}")
    return rv.exchange(p, x, axes)


def _report(op: str, result, axes) -> None:
    """Charge an in-step collective to the active cost walker, once: from
    position 0, per device."""
    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    rv, p = _POSITION.state
    if walker is not None and p == 0:
        walker.collective(op, hlo_analysis.tensor_bytes(result),
                          hlo_analysis.group_size(rv.mesh, _axes(axes)))


def psum(x, axes):
    """The sum of ``x`` over the positions of this position's group along
    ``axes`` (a name or a tuple of names), added in position order."""
    values, i = _exchange(x, axes)
    out = _psum(values)[i]
    _report("all-reduce", out, axes)
    return out


def pmax(x, axes):
    """The elementwise maximum of ``x`` over the group along ``axes``."""
    import torch
    values, i = _exchange(x, axes)
    acc = values[0].to(x.device)
    for v in values[1:]:
        acc = torch.maximum(acc, v.to(x.device))
    return acc


def all_gather(x, axes, *, axis: int = 0, tiled: bool = False):
    """The group's values along ``axes`` stacked on a new dim ``axis``
    (``tiled=True``: concatenated along ``axis``), in position order, as
    ``jax.lax.all_gather``."""
    import torch
    values, i = _exchange(x, axes)
    if tiled:
        out = _all_gather(values, axis)[i]
    else:
        out = torch.stack([v.to(x.device) for v in values], axis)
    _report("all-gather", out, axes)
    return out
