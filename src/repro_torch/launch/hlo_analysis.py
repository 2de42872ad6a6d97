"""The port's cost walker: loop-aware FLOP / byte / collective accounting.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses
a compiled step's HLO text and multiplies each ``while`` body by its trip
count; the port has no HLO, so :class:`CostWalker` counts the step as it
runs: a ``TorchDispatchMode`` that sees every aten op the step dispatches
(the backward's included).  A Python loop is counted as it runs, which is
what the reference gets by multiplying through trip counts.

* FLOPs — ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, conv and its backward, SDPA): 2 · |result| · K for a product,
  the reference's ``_dot_flops``.
* Bytes — every eager op materializes, so each non-view op moves its
  operands plus its result (an expanded operand counted once, a view by
  its own elements).  An in-place write into a slice charges the slice,
  as the reference's ``_ALIASING`` does; ``copy_`` and fills do not read
  their destination.
* Transcendentals — the output elements of exp, tanh, log, rsqrt,
  sigmoid and erf, and of the ops built on one of them (softmax,
  log-softmax, gelu, silu), one each.
* Collectives — what the port's lockstep executor really does reports
  itself to the active walker (:func:`active`): ``PlacedArray.gather``
  (an all-gather), the reductions in position order of
  ``spmd.over_blocks`` (an all-reduce; its concatenation an all-gather),
  the group collectives of the tensor-parallel layer forms (inside a
  compute block, at its share) with, in the backward, what carries their
  gradients back (``collectives.charge_backward``: the sum of a shared
  activation's partial gradients, an all-gather's transpose), and the
  in-step ``psum`` / ``all_gather``.  Each is charged with the reference's ring formulas (:func:`_collective_moved`) for its group
  size, and its result bytes are added to ``bytes``, as the reference
  adds them; the copies that carry it out are not charged again.
* Kernels — a kernel wrapper called on meta tensors returns a meta
  result and charges the kernel's work (its operands and result once,
  its FLOPs) through :meth:`CostWalker.kernel`; it never runs the plain
  version.

Per device: ``share(w)`` scales what the ops inside it charge to
:attr:`CostWalker.cost`.  The dry-run (:mod:`repro_torch.launch.dryrun`)
runs a step at share ``1 / positions`` (the executor does the mesh's work
once: each position's share of it), ``spmd.over_blocks`` runs each
compute block at the share of the positions that compute it, and
``spmd.per_position`` each model position's part of a layer at ``1 / n``
of that (:meth:`CostWalker.times` charges one part for all on meta
tensors).
:attr:`CostWalker.total` charges everything in full: the work of the
whole step as one device runs it when every position sits on it.

The walker also keeps the live bytes of the storages the ops it sees
allocate, and their peak (:meth:`CostWalker.block` reads the peak above
a block's start).  Nothing here touches a device or reads a tensor's
values, so a step on ``meta`` tensors is costed without running.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

__all__ = ["CostWalker", "HloCost", "active", "analyze", "group_size",
           "muted", "tensor_bytes"]

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

# Ops whose every output element is one transcendental evaluation.
_TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "expm1", "tanh", "tanh_", "log", "log_", "log1p",
    "log2", "rsqrt", "rsqrt_", "sigmoid", "sigmoid_", "erf", "erf_",
    "_softmax", "_log_softmax", "gelu", "gelu_", "silu", "silu_"})

# Ops that allocate a tensor without moving its bytes.
_ALLOCATE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})
# Ops that describe a tensor they are given: no traffic, no new storage.
_DESCRIBE = frozenset({"lift_fresh", "_local_scalar_dense", "sym_size",
                       "sym_stride", "sym_numel", "sym_storage_offset",
                       "is_same_size"})

# In-place ops that write their first operand without reading it.
_OVERWRITE = frozenset({"copy_", "fill_", "zero_"})


def _collective_moved(op: str, nbytes: float, g: int) -> float:
    """Per-device link bytes of one collective over a group of ``g`` (the
    reference's ring formulas; ``nbytes`` is the result's size)."""
    if op == "all-reduce":
        return 2 * (g - 1) / g * nbytes
    if op == "all-gather":
        return (g - 1) / g * nbytes          # result = gathered tensor
    if op == "reduce-scatter":
        return float((g - 1)) * nbytes       # result = the shard
    if op == "all-to-all":
        return (g - 1) / g * nbytes
    return nbytes                             # collective-permute


@dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective: dict = field(default_factory=lambda: {
        k: 0.0 for k in _COLL_OPS} | {"count": 0.0})
    ops: float = 0.0                          # aten ops charged

    def add(self, other: "HloCost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.transcendentals += other.transcendentals * mult
        self.ops += other.ops * mult
        for k in self.collective:
            self.collective[k] += other.collective.get(k, 0.0) * mult

    @property
    def collective_total(self) -> float:
        return sum(v for k, v in self.collective.items() if k != "count")


def tensor_bytes(t) -> int:
    """The bytes a tensor's elements span: its own elements for a view,
    an expanded (stride-0) dim counted once."""
    span = 1
    for n, s in zip(t.shape, t.stride()):
        if n == 0:
            return 0
        if s != 0:
            span += (n - 1) * abs(s)
    return min(span, t.numel()) * t.element_size()


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


# The walkers in force, innermost last.  Not thread-local: the in-step
# collectives of shard_map's threads report to the walker that started
# them.
_ACTIVE: list = []


def active() -> "CostWalker | None":
    """The innermost walker in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def muted():
    """The active walker's :meth:`CostWalker.muted`, or no context."""
    walker = active()
    return walker.muted() if walker is not None else contextlib.nullcontext()


def group_size(mesh, axes) -> int:
    """The positions a collective over ``axes`` joins (the product of each
    axis's group in ``Mesh.groups``)."""
    n = 1
    for a in axes:
        n *= len(mesh.groups(a)[0])
    return n


class _Block:
    """What :meth:`CostWalker.block` yields: the cost charged inside the
    block (the walker's counts after it less those before it)."""

    def __init__(self, walker: "CostWalker"):
        self.cost, self.total = HloCost(), HloCost()
        self.cost.add(walker.cost, -1.0)
        self.total.add(walker.total, -1.0)

    def result(self, out) -> "tuple[HloCost, HloCost, object]":
        return self.cost, self.total, out


def _mode_base():
    from torch.utils._python_dispatch import TorchDispatchMode
    return TorchDispatchMode


class CostWalker:
    """``with CostWalker() as w: step(...)`` — ``w.cost`` is the
    :class:`HloCost` of what ran inside, ``w.peak_bytes`` the most bytes
    the ops it saw held alive at once."""

    def __init__(self):
        self.cost = HloCost()                 # at each op's share
        self.total = HloCost()                # every op in full
        self.weight = 1.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.block_temp = 0                   # max over blocks(): peak above
        self.blocks = 0                       # the block's start
        self._muted = 0
        self._forward = 0
        self._node_share: dict[int, tuple] = {}
        self._seen: dict[int, int] = {}
        self._mode = None

    # ------------------------------------------------------------ context
    def __enter__(self) -> "CostWalker":
        walker = self

        class _Mode(_mode_base()):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                walker._observe(func, args, kwargs or {}, out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._mode.__exit__(*exc)
        self._mode = None

    @contextlib.contextmanager
    def share(self, weight: float):
        """Within this context every op, kernel and FLOP charges
        ``weight`` of itself (collectives, per device already, do not)."""
        before, self.weight = self.weight, float(weight)
        try:
            yield self
        finally:
            self.weight = before

    @contextlib.contextmanager
    def muted(self):
        """Within this context ops are tracked for memory but charge
        nothing: the copies that carry out a collective already charged."""
        self._muted += 1
        try:
            yield self
        finally:
            self._muted -= 1

    @contextlib.contextmanager
    def block(self):
        """One compute block: its peak live bytes above the bytes live at
        its start (its inputs) join :attr:`block_temp`'s maximum.  Yields
        a :class:`_Block` that records the block's cost."""
        start, outer_peak = self.live_bytes, self.peak_bytes
        self.peak_bytes = start
        blk = _Block(self)
        try:
            yield blk
        finally:
            self.block_temp = max(self.block_temp, self.peak_bytes - start)
            self.blocks += 1
            self.peak_bytes = max(outer_peak, self.peak_bytes)
            blk.cost.add(self.cost)
            blk.total.add(self.total)

    @contextlib.contextmanager
    def times(self, n: int):
        """What the ops inside charge, charged ``n`` times over: one of
        ``n`` computations alike (the model positions of a unit on meta
        tensors) run for all of them."""
        blk = _Block(self)
        try:
            yield self
        finally:
            blk.cost.add(self.cost)
            blk.total.add(self.total)
            self.cost.add(blk.cost, n - 1.0)
            self.total.add(blk.total, n - 1.0)

    def repeat(self, ran: "tuple[HloCost, HloCost, object]"):
        """Charge a block already run (``_Block.result``) once more and
        return its result: a block on meta tensors whose shapes repeat."""
        cost, total, out = ran
        self.cost.add(cost)
        self.total.add(total)
        self.blocks += 1
        return out

    # ---------------------------------------------------------- reporting
    def collective(self, op: str, nbytes: float, group: int, *,
                   weight: float = 1.0) -> None:
        """A collective of ``op`` whose result is ``nbytes`` over a group
        of ``group`` positions; a group of one moves nothing.  ``weight``
        scales what :attr:`cost` is charged: a collective inside a compute
        block, which a device runs for its own block only, is charged at
        the block's share."""
        if group < 2:
            return
        for c, w in ((self.cost, weight), (self.total, 1.0)):
            c.collective[op] += w * _collective_moved(op, nbytes, group)
            c.collective["count"] += w
            c.bytes += w * nbytes

    # ------------------------------------------------- the backward's share
    @contextlib.contextmanager
    def forward(self):
        """Within this context ops are forward ops at the current share,
        even inside a backward node (a checkpointed region recomputed)."""
        self._forward += 1
        try:
            yield self
        finally:
            self._forward -= 1

    def tag_nodes(self, start: int, stop: int, mult: float) -> None:
        """The autograd nodes of sequence numbers ``start:stop`` (created
        by one position's part, at the current share) run their backward
        at that share times ``mult`` and count ``mult`` times in
        :attr:`total`: ``mult`` positions alike whose one part was run
        for all (meta tensors), else 1.  A node already tagged by an inner
        part keeps its share and multiplies its count."""
        for seq in range(start, stop):
            if seq in self._node_share:
                w, m = self._node_share[seq]
                self._node_share[seq] = (w, m * mult)
            else:
                self._node_share[seq] = (self.weight * mult, mult)

    def _shares(self) -> tuple:
        """(the share a charge takes now, how many times it counts in
        :attr:`total`): a backward node tagged by :meth:`tag_nodes` gives
        its own, anything else the current share, once."""
        if not self._forward and self._node_share:
            import torch
            node = torch._C._current_autograd_node()
            if node is not None:
                got = self._node_share.get(node._sequence_nr())
                if got is not None:
                    return got
        return self.weight, 1.0

    def _charge(self, flops: float, nbytes: float,
                transcendentals: float) -> None:
        share, times = self._shares()
        for c, w in ((self.cost, share), (self.total, times)):
            c.flops += w * flops
            c.bytes += w * nbytes
            c.transcendentals += w * transcendentals
            c.ops += w

    def kernel(self, *, flops: float, nbytes: float,
               transcendentals: float = 0.0) -> None:
        """One hand-written kernel's work, at the current share."""
        self._charge(flops, nbytes, transcendentals)

    # ------------------------------------------------------------ the ops
    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def _observe(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in _DESCRIBE:
            return
        if not name.endswith("_"):          # in place: no new storage
            self._track(out)
        if self._muted or name in _ALLOCATE:
            return
        from torch.utils.flop_counter import flop_registry
        ins = list(_tensors(list(args) + list(kwargs.values())))
        if name in _OVERWRITE and ins:
            ins = ins[1:]
        outs = list(_tensors(out))
        count = flop_registry.get(func.overloadpacket)
        self._charge(
            count(*args, **kwargs, out_val=out) if count is not None else 0.0,
            sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs)),
            outs[0].numel() if name in _TRANSCENDENTAL and outs else 0.0)


def analyze(fn, *args, **kwargs) -> HloCost:
    """The cost of ``fn(*args, **kwargs)`` as it runs (the reference's
    ``analyze(hlo_text)``: the port's step is its own program text)."""
    with CostWalker() as walker:
        fn(*args, **kwargs)
    return walker.cost
