"""The lockstep executor behind the LM stack's sharded steps.

The reference hands a train, serve or prefill step to ``jax.jit`` with
per-leaf shardings, and GSPMD partitions it however it likes, promising
the unsharded step's results.  The port keeps that promise with one
explicit scheme on its single-controller mesh (one process drives every
position of a :class:`~repro_torch.launch.mesh.Mesh` in lockstep):

* state lives as :class:`~repro_torch.distributed.sharding.PlacedArray`\\ s,
  one local tensor a position: parameters and optimizer state by
  ``param_specs`` (FSDP over ``data``, tensor-parallel dims over
  ``model``), the batch by ``batch_specs``, the decode cache by
  ``cache_specs``;
* a *compute unit* is a data block of the batch and a position along
  ``model``.  The positions that share data coordinates share one data
  block (:func:`compute_blocks`); along ``model`` each computes the heads,
  ``d_ff`` columns, experts, SSM heads, RG-LRU channels and vocab slice
  its shards hold, as the reference's sharding rules lay the work out.
  :func:`unit_params` gathers each weight over the data axes only (FSDP
  gathers at use), one copy a model position that every data block
  shares: a leaf split over ``model`` reaches the model code as
  :class:`Shards`, one part a model position, and the layer forms of
  ``models/`` run each position's part (:func:`per_position`) and combine
  the partial results with the group collectives of
  :mod:`~repro_torch.distributed.collectives` (``group_psum`` in position
  order, ``group_pmax``, ``group_all_gather``).  Only the weights the
  model forms read whole are gathered over ``model`` too: Mamba-2's
  ``in_proj`` and ``conv`` (split at the middle of their packed columns,
  not by head) and ``wk`` / ``wv`` where the KV heads do not divide;
* the step reduces across the data blocks in position order
  (:func:`over_blocks`, the body that the train, serve and prefill steps
  share), and writes each position's slice of the result into its own
  tensors, in place where the reference donates them.  The serve step
  reads and writes every position's cache shard where it lies
  (:func:`cache_view`).

A MoE layer sizes its dispatch capacity per chunk of ``min(1024, T)``
tokens of the whole batch, so blocks whose tokens share a chunk are
computed together (:func:`compute_blocks`): the drops are those of the
unsharded step.  Such a block's decode cache spans several data shards
(:class:`Rows`), and the layers that read it run once a shard.

:class:`LockstepStep` runs such a step: eagerly on the CPU or with
``jit=False``; on the card, with every position on that card, captured
into one CUDA graph through :class:`~repro_torch.core.capture.
CapturedProgram` with every shard bound (read and written where it lies,
never copied).  A step that cannot be captured raises
:class:`~repro_torch.core.capture.CaptureError`, and so does ``jit=True``
on a mesh whose positions one process drives on several cards.

A mesh split over ranks, one process a card (:func:`~repro_torch.launch.
mesh.rank_mesh`), runs the same steps: a rank holds its positions' shards
only, computes the blocks whose data shard it holds (:func:`block_owner`),
gathers what it needs of the others' shards and blocks through
:func:`~repro_torch.distributed.collectives.exchange` and combines them
in the single-process order, so every rank's result is the
single-process one bit for bit; on the card each rank's step is one CUDA
graph with NCCL inside.  A rank computes every model position of the
blocks it holds; a rank that holds no block raises (the model axis split
over ranks is not ported).
"""

from __future__ import annotations

from typing import Any, Callable

from .sharding import PlacedArray, current_mesh, use_mesh

__all__ = ["LockstepStep", "Rows", "Shards", "cache_view", "compute_blocks",
           "local_grad", "moe_chunk", "over_blocks", "per_position",
           "recomputed", "shard_env", "sync_replicas", "unit_leaves",
           "unit_map", "unit_params", "whole_batch", "write_blocks"]

ITEM_10 = "ROADMAP.md, Queue 1 item 10 (Multi-card meshes)"


class Shards:
    """One leaf of a compute unit split over a mesh axis: ``parts``, the
    part each position along ``axis`` holds, in position order, and
    ``dim``, the dim they split.  Along ``model`` a part is the weight (or
    decode-cache rows) that model position computes with; along ``data``
    (the weight-stationary decode, ``REPRO_DECODE_WSTAT``) a part is a
    position's FSDP shard, contracted where it lies.  Indexing and
    ``unbind`` act on every part, as on the stacked tensor they split, so
    a stacked tree of them is sliced by layer as a tree of tensors is."""

    __slots__ = ("parts", "dim", "axis")

    def __init__(self, parts, dim: int, axis: str = "model"):
        self.parts = list(parts)
        self.dim = dim
        self.axis = axis

    @property
    def n(self) -> int:
        return len(self.parts)

    def _inner(self, parts):
        return Shards(parts, self.dim - 1, self.axis)

    def __getitem__(self, i: int) -> "Shards":
        if self.dim == 0:
            raise IndexError("indexing the split dim of a Shards")
        return self._inner([p[i] for p in self.parts])

    def unbind(self, dim: int = 0) -> tuple:
        if dim != 0 or self.dim == 0:
            raise ValueError("Shards unbind their leading, unsplit dim only")
        each = [p.unbind(0) for p in self.parts]
        return tuple(self._inner([u[i] for u in each])
                     for i in range(len(each[0])))

    def __repr__(self) -> str:
        return (f"Shards({self.n} x {tuple(_first(self).shape)} over "
                f"{self.axis!r}, dim {self.dim})")


def _first(t):
    while isinstance(t, Shards):
        t = t.parts[0]
    return t


class Rows:
    """A decode-cache leaf of a compute block that spans several data
    shards (a MoE block): ``blocks``, ``(lo, hi, leaf)`` for each shard in
    order, ``lo:hi`` its rows within the block and ``leaf`` those rows as
    they lie (a tensor or :class:`Shards` over ``model``)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def __getitem__(self, i: int) -> "Rows":
        return Rows([(lo, hi, t[i]) for lo, hi, t in self.blocks])


def per_position(n: int, fn: Callable, like) -> list:
    """``[fn(0), ..., fn(n - 1)]``: the share of each of ``n`` positions
    of a group, one after another.  Under a cost walker each runs at
    ``1 / n`` of the current share (a position computes its own), and the
    autograd nodes it creates are tagged so that their backward runs at
    that share too; on meta tensors (``like`` is one) the parts have one
    shape, so position 0 runs for all and is charged ``n`` times, forward
    and backward."""
    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    if walker is None:
        return [fn(m) for m in range(n)]
    meta = _first(like).device.type == "meta"
    out = []
    with walker.share(walker.weight / n):
        for m in range(1 if meta else n):
            start = _next_node()
            if meta:
                with walker.times(n):
                    out.append(fn(m))
            else:
                out.append(fn(m))
            walker.tag_nodes(start, _next_node(), n if meta else 1)
    return out * n if meta else out


def recomputed(fn: Callable) -> Callable:
    """``fn`` as a checkpointed region runs it: under a cost walker its
    recompute, which runs inside the backward, is charged as forward
    work."""
    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    if walker is None:
        return fn

    def run(*a):
        with walker.forward():
            return fn(*a)

    return run


def _next_node() -> int:
    """The sequence number the next autograd node of this thread takes."""
    import torch

    from ..launch import hlo_analysis
    with torch.enable_grad(), hlo_analysis.muted():
        return torch.zeros((), requires_grad=True).neg().grad_fn._sequence_nr()


# --------------------------------------------------------------------------
# a unit's parameters: gathered over the data axes, split over `model`
# --------------------------------------------------------------------------


def _model_dim(sharding) -> int | None:
    """The dim ``sharding`` splits over ``model`` alone, or None."""
    if sharding.mesh.shape.get("model", 1) < 2:
        return None
    for d, entry in enumerate(sharding.spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "model" in axes:
            return d if axes == ("model",) else None
    return None


def _data_dim(sharding) -> int | None:
    for d, entry in enumerate(sharding.spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "data" in axes:
            return d if axes == ("data",) else None
    return None


def _holders(a: PlacedArray, fixed: dict) -> dict:
    """{block: the first position of this process holding it}, over the
    blocks whose index along each dim of ``fixed`` is its value (on a
    mesh split over ranks, the blocks this rank holds)."""
    out: dict = {}
    for q in a.local_shards():
        b = a.sharding.block(q, a.ndim)
        if all(b[d] == i for d, i in fixed.items()):
            out.setdefault(b, q)
    return out


def _region(t, a: PlacedArray, block: tuple, dim: int | None, m: int):
    """The view of ``t`` — the part of ``a`` that model position ``m``
    holds along ``dim`` (the whole array when ``dim`` is None) — where the
    shard of ``block`` lies."""
    local = a.sharding.shard_shape(a.shape)
    for d, n in enumerate(local):
        if n != t.shape[d]:
            off = block[d] * n - (m * t.shape[d] if d == dim else 0)
            t = t.narrow(d, off, n)
    return t


def _model_local(a: PlacedArray, m: int, dim: int):
    """What model position ``m`` holds of ``a``: its shards along ``dim``
    gathered over the other axes (one all-gather over the data axes,
    charged by the caller; across ranks, :meth:`PlacedArray.block_shards`);
    the shard itself when it is all of it."""
    import torch

    from ..launch import hlo_analysis
    shards = a.block_shards(lambda b: b[dim] == m)
    shape = list(a.shape)
    shape[dim] //= a.sharding.parts(dim)
    first = next(iter(shards.values()))
    if len(shards) == 1 and list(first.shape) == shape:
        return first
    out = torch.empty(shape, dtype=a.dtype, device=first.device)
    with hlo_analysis.muted():
        for b, shard in shards.items():
            _region(out, a, b, dim, m).copy_(shard)
    return out


def _data_parts(a: PlacedArray, m: int, dim: int | None, ddim: int):
    """The FSDP shards of ``a`` along ``ddim`` that model position ``m``
    holds (``dim`` its model dim, or None), as they lie."""
    fixed = {} if dim is None else {dim: m}
    parts = []
    for j in range(a.sharding.parts(ddim)):
        q = next(iter(_holders(a, {**fixed, ddim: j}).values()))
        parts.append(a.shards[q])
    return Shards(parts, ddim, "data")


def _wstat_leaf(path: str) -> bool:
    """The weights the weight-stationary decode contracts where they lie:
    every dense ``.../w`` that the model reads through ``linear`` or the
    LM head (the router and Mamba-2's column-sliced ``in_proj`` are
    gathered)."""
    return path.endswith("/w") and not path.endswith(("router/w",
                                                      "in_proj/w"))


def unit_params(params: Any, split: Callable[[str], bool], *,
                wstat: bool = False) -> Any:
    """The compute units' parameters: every placed leaf of ``params``
    gathered over the data axes.  A leaf split over ``model`` whose path
    ``split`` accepts (``models.transformer.tp_split``: the leaves the
    model forms read split) becomes :class:`Shards` of the model
    positions' parts (shared by every data block); any other leaf is
    gathered whole.
    With ``wstat`` the dense weights (:func:`_wstat_leaf`) stay where they
    lie, as :class:`Shards` over ``data``.  Under a cost walker a
    position's gather is one all-gather over the axes it spans."""
    from ..launch import hlo_analysis
    walker = hlo_analysis.active()

    def leaf(path, a):
        if not isinstance(a, PlacedArray):
            return a
        sh = a.sharding
        if wstat and sh.mesh.distributed:
            raise NotImplementedError(
                f"the weight-stationary decode across ranks is not ported "
                f"yet ({ITEM_10})")
        dim = _model_dim(sh)
        if dim is not None and not split(path):
            dim = -1                                # gathered whole
        ddim = _data_dim(sh) if wstat and _wstat_leaf(path) else None
        if dim == -1 or (dim is None and ddim is None):
            return a.gather()
        n = sh.mesh.shape.get("model", 1) if dim is not None else 1
        if ddim is not None:
            return (_data_parts(a, 0, None, ddim) if dim is None else
                    Shards([_data_parts(a, m, dim, ddim) for m in range(n)],
                           dim))
        parts = [_model_local(a, m, dim) for m in range(n)]
        if walker is not None:
            walker.collective("all-gather",
                              hlo_analysis.tensor_bytes(parts[0]),
                              len(_holders(a, {dim: 0})))
        return Shards(parts, dim)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        return leaf(path, t)

    return walk(params, "")


def unit_map(fn: Callable, tree: Any, *rest) -> Any:
    """``fn`` over the tensors of a unit tree (nested dicts whose leaves are
    tensors or :class:`Shards`), ``rest`` nested alike."""
    if isinstance(tree, dict):
        return {k: unit_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards([unit_map(fn, p, *(r.parts[i] for r in rest))
                       for i, p in enumerate(tree.parts)], tree.dim, tree.axis)
    return fn(tree, *rest)


def unit_leaves(tree: Any) -> list:
    """The tensors of a unit tree, the parts of a :class:`Shards` in
    position order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in unit_leaves(v)]
    if isinstance(tree, Shards):
        return [x for p in tree.parts for x in unit_leaves(p)]
    return [tree]


def local_grad(a: PlacedArray, g, q: int):
    """Position ``q``'s slice of ``g``, the gradient of leaf ``a`` in its
    unit form (a whole tensor, or :class:`Shards` over ``model``)."""
    b = a.sharding.block(q, a.ndim)
    if isinstance(g, Shards):
        return _region(g.parts[b[g.dim]], a, b, g.dim, b[g.dim])
    return a.sharding.local(g, q)


# --------------------------------------------------------------------------
# the decode cache where it lies
# --------------------------------------------------------------------------


def cache_view(cache: Any, r0: int, r1: int, pos) -> Any:
    """The decode cache of the compute block of rows ``r0:r1`` as the model
    reads and writes it: every leaf as views of the positions' shards
    where they lie (:class:`Shards` over ``model`` where it is split
    there, else the first holder's rows; :class:`Rows` where the block
    spans several data shards), ``pos`` as ``pos`` given.  Nothing is
    gathered or copied."""
    from .sharding import cache_batch_dim

    def leaf(path, a):
        bd = cache_batch_dim(path, a.ndim)
        if bd is None:
            return pos
        rows = a.shape[bd] // a.sharding.parts(bd)
        dim = _model_dim(a.sharding)
        n = a.sharding.mesh.shape.get("model", 1) if dim is not None else 1
        out = []
        for j in range(r0 // rows, (r1 - 1) // rows + 1):
            lo, hi = max(r0, j * rows), min(r1, (j + 1) * rows)

            def part(m, j=j, lo=lo, hi=hi):
                fixed = {bd: j} if dim is None else {bd: j, dim: m}
                q = next(iter(_holders(a, fixed).values()))
                return a.shards[q].narrow(bd, lo - j * rows, hi - lo)

            out.append((lo - r0, hi - r0, part(0) if dim is None else
                        Shards([part(m) for m in range(n)], dim)))
        return out[0][2] if len(out) == 1 else Rows(out)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        return leaf(path, t)

    return walk(cache, "")


def sync_replicas(a: PlacedArray) -> None:
    """Copy every block of ``a`` from the first position of this process
    holding it to the others of this process that hold it (the step wrote
    the first one; on a mesh split over ranks every rank computed the
    same block)."""
    holders: dict = {}
    for q in a.local_shards():
        holders.setdefault(a.sharding.block(q, a.ndim), []).append(q)
    for qs in holders.values():
        for q in qs[1:]:
            a.shards[q].copy_(a.shards[qs[0]])


def moe_chunk(cfg) -> int | None:
    """The token chunk of ``cfg``'s MoE dispatch (None without MoE), as
    ``models/layers.py: moe_apply`` reads it."""
    if cfg.moe is None:
        return None
    from ..models import layers
    return layers._MOE_CHUNK or 1024


def compute_blocks(rows: int, parts: int, row_tokens: int,
                   chunk: int | None = None) -> list[tuple[int, int]]:
    """The ``(start, stop)`` rows of each compute block of a batch of
    ``rows`` rows split into ``parts`` data-parallel shards (one block a
    shard, in order; one block when ``parts`` does not divide ``rows``).
    With a MoE ``chunk`` (tokens), consecutive shards are merged until a
    block holds whole dispatch chunks of ``min(chunk, rows · row_tokens)``
    tokens, so no chunk spans two blocks."""
    if parts < 1 or rows % parts:
        parts = 1
    per = rows // parts
    k = 1
    if chunk:
        whole = min(chunk, rows * row_tokens)
        k = next(j for j in range(1, parts + 1)
                 if parts % j == 0 and (j * per * row_tokens) % whole == 0)
    return [(i * per * k, (i + 1) * per * k) for i in range(parts // k)]


def block_owner(mesh, r0: int, rows: int) -> int:
    """The rank that computes the compute block starting at row ``r0`` of
    a microbatch of ``rows`` rows: the rank of the first position holding
    its data shard (the batch split over the data axes by
    ``batch_specs``)."""
    axes = _data_axes(mesh)
    parts = 1
    for a in axes:
        parts *= mesh.shape[a]
    if rows % parts:                    # one block: compute_blocks' rule
        return mesh.rank_of(0)
    j = (r0 % rows) // (rows // parts)
    for p in range(mesh.size):
        c, i = mesh.coords(p), 0
        for a in axes:
            i = i * mesh.shape[a] + c[a]
        if i == j:
            return mesh.rank_of(p)
    raise AssertionError(j)


def block_rows(a: PlacedArray, r0: int, r1: int):
    """Rows ``r0:r1`` of the placed batch leaf ``a`` (split over dim 0)
    from a shard of this process, as it lies: a rank reads only its own
    blocks' rows."""
    n = a.shape[0] // a.sharding.parts(0)
    j = r0 // n
    for q, shard in a.local_shards().items():
        if a.sharding.block(q, a.ndim)[0] == j and r1 <= (j + 1) * n:
            return shard.narrow(0, r0 - j * n, r1 - r0)
    raise NotImplementedError(
        f"rows {r0}:{r1} span data shards this rank does not hold (a MoE "
        f"block merged across ranks is not ported yet: {ITEM_10})")


def _combine_across(mesh, skeleton: Any, folded: list | None, held: dict,
                    owners: list, combine: str) -> Any:
    """The blocks' results combined on a mesh split over ranks.
    ``owners`` is the rank of every block; ``held`` maps this rank's
    blocks to their leaves, or, where one rank holds every block of a
    sum, ``folded`` holds the leaves of their float32 running sum.  Leaf
    by leaf, one exchange brings every block's value (or the folded sum),
    each rank sending its own; then the leaf is summed in float32 in block
    order or concatenated in order: the single-process arithmetic on
    every rank.  ``skeleton`` is the results' tree with None for
    leaves."""
    import torch

    from .collectives import exchange
    mine = {-1: folded} if folded is not None else dict(held)
    if not mine:
        raise NotImplementedError(
            f"rank {mesh.rank} computes no data block of this batch; a "
            f"rank without one is not ported yet ({ITEM_10})")
    keys = [-1] if folded is not None else range(len(owners))
    combined = []
    for k in range(len(next(iter(mine.values())))):
        send = {i: v[k] for i, v in mine.items()}
        for v in mine.values():         # one leaf of the blocks at a time
            v[k] = None
        got = exchange(mesh, send, keys, ranks=range(mesh.world),
                       rank_of=lambda i: owners[max(i, 0)])
        del send
        if combine == "cat":
            combined.append(torch.cat(got))
        else:
            acc = got[0].float()
            for t in got[1:]:
                acc.add_(t.float())
            combined.append(acc)
        del got
    it = iter(combined)
    return unit_map(lambda _: next(it), skeleton)


def over_blocks(params: Any, blocks: list[tuple[int, int]],
                fn: Callable, combine: str, *, split: Callable[[str], bool],
                wstat: bool = False, microbatches: int = 1) -> Any:
    """The body of every sharded step: build the units' parameters of
    ``params`` once (:func:`unit_params` with ``split`` and ``wstat``), run
    ``fn(unit_params, r0, r1)`` on each compute block ``(r0, r1)`` in
    order, and combine its results (a dict of tensors or :class:`Shards`
    each, nested alike) leaf by leaf: ``"cat"`` concatenates them along
    dim 0, ``"sum"`` adds them in float32 in block order into one running
    sum, so one block's results are alive beside it at a time.  The
    gathered parameters are dropped before it returns.

    ``blocks`` may span ``microbatches`` equal microbatches one after
    another.  Under a cost walker (:mod:`repro_torch.launch.hlo_analysis`)
    each block runs at the share of the positions that compute it (its
    rows over a microbatch's), and the combination is one collective over
    the data axes: the sum an all-reduce, the concatenation an
    all-gather, of a position's part.  On meta parameters a block's result
    and cost follow from its row count alone, so a block of a row count
    already run is charged that block's cost again and returns its result
    (:meth:`~repro_torch.launch.hlo_analysis.CostWalker.repeat`).

    On a mesh split over ranks (the ambient mesh) a rank runs the blocks
    whose data shard it holds (:func:`block_owner`; a single rank folds
    every block into the running sum as one process does), and the
    results meet across ranks leaf by leaf
    (:func:`_combine_across`): every rank gets the single-process
    combination bit for bit."""
    import torch

    from ..launch import hlo_analysis
    walker = hlo_analysis.active()
    rows = sum(r1 - r0 for r0, r1 in blocks) / microbatches
    unit = unit_params(params, split, wstat=wstat)
    mesh = current_mesh()
    if mesh is not None and mesh.distributed:
        owners = [block_owner(mesh, r0, int(rows)) for r0, _ in blocks]
        # one rank holding every block of a sum folds them as one process
        # does; across ranks each holds as many blocks as the others, and
        # a folded float32 sum would move more bytes than its blocks
        fold = combine == "sum" and mesh.world == 1
        skeleton, acc, held = None, None, {}
        for i, (r0, r1) in enumerate(blocks):
            if owners[i] != mesh.rank:
                continue
            out = fn(unit, r0, r1)
            if skeleton is None:
                skeleton = unit_map(lambda _: None, out)
            leaves = unit_leaves(out)
            del out
            if not fold:
                held[i] = leaves
            elif acc is None:
                acc = [t.float() for t in leaves]
            else:
                for a, t in zip(acc, leaves):
                    a.add_(t.float())
            del leaves
        del unit
        return _combine_across(mesh, skeleton, acc, held, owners, combine)
    on_meta = all(t.device.type == "meta" for t in unit_leaves(unit))
    parts, acc, ran = [], None, {}
    for r0, r1 in blocks:
        if walker is None:
            out = fn(unit, r0, r1)
        elif on_meta and (r1 - r0) in ran:
            out = walker.repeat(ran[r1 - r0])
        else:
            with walker.block() as blk, walker.share((r1 - r0) / rows):
                out = fn(unit, r0, r1)
            ran[r1 - r0] = blk.result(out)
        with hlo_analysis.muted():
            if combine == "cat":
                parts.append(out)
            elif acc is None:
                acc = unit_map(lambda t: t.float(), out)
            else:
                for a, t in zip(unit_leaves(acc), unit_leaves(out)):
                    a.add_(t.float())
    del unit
    with hlo_analysis.muted():
        result = acc if combine == "sum" else unit_map(
            lambda *ts: torch.cat(ts), *parts)
    if walker is not None:
        mesh = current_mesh()
        group = (hlo_analysis.group_size(mesh, _data_axes(mesh))
                 if mesh is not None else len(blocks) // microbatches)
        nbytes = sum(hlo_analysis.tensor_bytes(_first(t))
                     for t in _unit_tops(result))
        walker.collective("all-reduce" if combine == "sum" else "all-gather",
                          nbytes, group)
    return result


def _unit_tops(tree: Any) -> list:
    """The leaves of a unit tree, a :class:`Shards` one leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _unit_tops(v)]
    return [tree]


def _data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def whole_batch(batch: dict, float_dtype) -> dict:
    """A batch of numpy arrays, tensors or placed arrays as whole tensors
    (placed ones gathered), float inputs (frames, patch embeddings) in
    ``float_dtype``, the model's."""
    import numpy as np
    import torch
    out = {}
    for k, v in batch.items():
        if isinstance(v, PlacedArray):
            v = v.gather()
        t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.array(v))
        out[k] = t.to(float_dtype) if t.is_floating_point() else t
    return out


def shard_env(tree: Any, prefix: str) -> dict:
    """``{name: shard}`` of every position's shard of every placed leaf of
    ``tree`` (other leaves by their path): the env a captured step binds."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, PlacedArray):
            for p, s in t.local_shards().items():
                out[f"{path}@{p}"] = s
        else:
            out[path] = t

    walk(tree, prefix)
    return out


def write_blocks(placed: PlacedArray, full) -> None:
    """Write every position's slice of the whole array ``full`` into its
    shard, in place (this process's positions only)."""
    sh = placed.sharding
    for p, s in placed.local_shards().items():
        s.copy_(sh.local(full, p))


class LockstepStep:
    """One step of a sharded program over ``mesh``: ``body()`` runs every
    position's share in lockstep (reading and writing the placed trees it
    closes over) and returns ``{output name: tensor}``; ``env`` names the
    tensors it reads and writes (:func:`shard_env`).  Each call runs with
    the mesh ambient.  With ``jit`` and every position on one card the
    step is captured into one CUDA graph at its first call (which runs
    eagerly), every env entry bound, and replayed after; the CPU and
    ``jit=False`` run it eagerly.  On a mesh split over ranks the step
    runs the rank's positions, and is captured per rank on its one card
    with the NCCL collectives inside the graph (its first, eager call has
    made the communicators and run every collective once)."""

    def __init__(self, mesh, name: str, body: Callable[[], dict],
                 outputs: list[str], *, jit: bool = True):
        self.mesh, self.name, self.jit = mesh, name, jit
        self.body = body
        self.outputs = list(outputs)
        self.program = None

    def _step(self, scope: dict) -> dict:
        del scope                       # the body reads its bound trees
        with use_mesh(self.mesh):
            return self.body()

    def __call__(self, env: dict) -> dict:
        from ..core.capture import CaptureError, CapturedProgram, run_steps
        steps = [(self.name, self._step)]
        devices = self.mesh.local_devices
        on_card = any(d.type == "cuda" for d in devices)
        if not self.jit or not on_card:
            return run_steps(steps, self.outputs, env)
        if len(devices) > 1:
            raise CaptureError(
                f"jit=True on {self.mesh!r}: capturing a step whose positions "
                f"sit on several devices of one process is not ported "
                f"({ITEM_10}); run one process a card "
                f"(repro_torch/launch/ranks.py: spawn, then launch.mesh."
                f"rank_mesh), run it with jit=False, or place every "
                f"position on one card")
        if self.mesh.distributed:
            import torch.distributed as dist
            if dist.get_backend() != "nccl":
                raise CaptureError(
                    f"jit=True on {self.mesh!r}: {dist.get_backend()}'s "
                    f"collectives run on the host and cannot be captured; "
                    f"run the ranks on NCCL, or the step with jit=False")
        if self.program is None or set(env) != self.program.bound:
            self.program = CapturedProgram(steps, self.outputs,
                                           bound=list(env))
        return self.program(env)
