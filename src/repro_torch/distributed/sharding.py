"""Sharding rules: parameter/batch/cache partition specs per architecture.

The pure rules of ``repro/distributed/sharding.py``, which the LM stack
(``ROADMAP.md``, Queue 1 item 7) imports:

* **Parameters** — 2D-sharded: the tensor-parallel dim (heads / d_ff /
  experts / vocab) over ``model``, the other large dim over ``data``
  (FSDP/ZeRO-3 posture).  Replicated over ``pod``.
* **Optimizer state** — same specs as its parameter.
* **Batch** — global batch over ("pod","data"); sequence unsharded.
* **KV cache / SSM state** — batch over data axes, heads/channels over
  ``model``.

A spec is a :class:`P`: one entry per dim, each a mesh-axis name, a tuple
of names, or ``None`` — the reference's ``PartitionSpec`` as a plain
tuple.  Rules are path-pattern based over the param tree (nested dicts,
lists or tuples whose leaves have ``.shape``), so every architecture
family (dense / MoE / SSM / hybrid / enc-dec) is covered by one table.
A mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names``: the port's :class:`~repro_torch.launch.mesh.Mesh`, or the
reference's.

The placement helpers are the reference's GSPMD ones on the port's
single-controller mesh (one process drives every position in lockstep):

* :func:`use_mesh` sets an ambient mesh (:func:`current_mesh`) that the
  sharded steps set while they run and model code may read;
* :class:`NamedSharding` is a mesh and a spec; :func:`param_shardings`,
  :func:`as_shardings` and :func:`replicated` build them as the
  reference's do;
* :func:`place` is the reference's ``jax.device_put``: it splits each
  leaf by its sharding into a :class:`PlacedArray`, one local tensor per
  position on that position's device, which gathers on
  :meth:`PlacedArray.gather` / ``numpy()``;
* :func:`shard_map` runs a function on every position's local shards,
  one thread a position, with the in-step collectives of
  :mod:`~repro_torch.distributed.collectives` (``psum``, ``pmax``,
  ``all_gather``) bound to the mesh's axes.

:func:`shard_hint` is the identity: a position's activations are whole
local tensors of its own program (the sharded steps split the batch and
gather the weights around the model), so there is nothing for a hint to
place.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["BATCH", "NamedSharding", "P", "PlacedArray", "ShardingSpecError",
           "as_shardings", "batch_specs", "cache_batch_dim", "cache_specs",
           "current_mesh", "gather", "param_shardings", "param_specs",
           "place", "replicated", "sanitize_spec", "shard_hint", "shard_map",
           "use_mesh"]

# stacked containers whose leaves carry a leading layer/group dim
_STACKED = ("groups", "encoder", "decoder")


class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ``("data",
    None)``, one entry per leading dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def _map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (the
    containers are rebuilt with the results)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _argmax(xs) -> int:
    return max(range(len(xs)), key=lambda i: (xs[i], -i))


def _param_spec(path: str, shape: tuple[int, ...], mesh, cfg) -> P:
    axes = set(mesh.axis_names)
    dp = "data" if "data" in axes else None
    tp = "model" if "model" in axes else None
    stacked = any(path.startswith(s + "/") or f"/{s}/" in path for s in _STACKED)
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape
    bn = len(body)

    def spec(*xs):
        return P(*(lead + tuple(xs)))

    # ---- embeddings ------------------------------------------------------
    if path.endswith("embed/tok"):
        return spec(tp, dp)
    if path.endswith("embed/pos"):
        return spec(None, tp)
    if path.endswith("lm_head/w"):
        return spec(dp, tp)

    # ---- norms / scalars ---------------------------------------------------
    if bn <= 1:
        return spec(*([None] * bn))

    # ---- MoE expert banks (leading E dim) ----------------------------------
    if "/mlp/" in path and bn == 3:
        E = body[0]
        tp_sz = mesh.shape.get("model", 1)
        if E >= tp_sz:
            # expert parallelism over `model`
            if path.endswith("w_out"):
                return spec(tp, None, dp)
            return spec(tp, dp, None)
        # few experts: shard the ffn dim instead
        if path.endswith("w_out"):
            return spec(None, tp, dp)
        return spec(None, dp, tp)
    if path.endswith("mlp/router/w"):
        return spec(dp, None)

    # ---- attention ---------------------------------------------------------
    if any(path.endswith(s) for s in ("wq/w", "wk/w", "wv/w")):
        return spec(dp, tp)
    if path.endswith("wo/w"):
        return spec(tp, dp)
    if any(path.endswith(s) for s in ("wq/b", "wk/b", "wv/b")):
        return spec(tp)

    # ---- dense FFN ---------------------------------------------------------
    if any(path.endswith(s) for s in ("w_in/w", "w_gate/w")):
        return spec(dp, tp)
    if path.endswith("w_out/w"):
        return spec(tp, dp)
    if any(path.endswith(s) for s in ("w_in/b", "w_gate/b")):
        return spec(tp)

    # ---- SSM ----------------------------------------------------------------
    if path.endswith("in_proj/w"):
        return spec(dp, tp)
    if path.endswith("out_proj/w"):
        return spec(tp, dp)
    if path.endswith("ssm/conv"):
        return spec(None, tp)

    # ---- RG-LRU -------------------------------------------------------------
    if any(path.endswith(s) for s in ("in_x/w", "in_y/w", "w_a/w", "w_i/w")):
        return spec(dp, tp)
    if path.endswith("rec/out/w"):
        return spec(tp, dp)
    if path.endswith("rec/conv"):
        return spec(None, tp)

    # default: shard the biggest dim over model when divisible, else replicate
    body_specs: list[Any] = [None] * bn
    big = _argmax(body)
    if tp and body[big] % mesh.shape["model"] == 0:
        body_specs[big] = tp
    return spec(*body_specs)


class ShardingSpecError(ValueError):
    """A partition spec names a mesh axis that does not exist or does not
    divide the dim it shards (raised by :func:`sanitize_spec` in strict
    mode instead of silently truncating the spec)."""


def sanitize_spec(spec, shape: tuple[int, ...], mesh, *,
                  strict: bool = True, path: str = "") -> P:
    """Validate ``spec`` against ``shape`` on ``mesh``.

    Strict (the default): raise :class:`ShardingSpecError` when a named
    axis is missing from the mesh or does not divide its dim evenly — a
    spec that silently degrades to replicated is a perf cliff, not a
    preference.

    ``strict=False`` drops the offending axes and keeps the rest, which is
    what the heuristic rule tables here want (e.g. a global batch of 1
    legitimately turns its batch sharding off).  ``path`` labels errors
    with the tree location.
    """
    if len(spec) > len(shape):
        raise ShardingSpecError(
            f"{path or 'spec'}: PartitionSpec{tuple(spec)} has "
            f"{len(spec)} entries for shape {tuple(shape)} of rank "
            f"{len(shape)}")
    out = []
    where = f" at {path!r}" if path else ""
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        size = shape[d]
        for a in axes:
            n = mesh.shape.get(a)
            if n is None:
                if strict:
                    raise ShardingSpecError(
                        f"spec{where} names mesh axis {a!r} on dim {d}, "
                        f"but the mesh only has axes "
                        f"{tuple(mesh.axis_names)}")
                continue
            if size % n == 0:
                keep.append(a)
                size //= n
            elif strict:
                raise ShardingSpecError(
                    f"spec{where} shards dim {d} (size {shape[d]}) over "
                    f"mesh axis {a!r} (size {n}), which does not divide "
                    f"it evenly; pass strict=False to drop the axis "
                    f"instead")
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def param_specs(params_or_shapes: Any, mesh, cfg, *,
                strict: bool = False) -> Any:
    """Partition-spec tree mirroring the param tree.

    The rule table is a placement *preference*, so by default dims the
    mesh cannot divide fall back to replicated.  ``strict=True`` turns
    every such fallback into a :class:`ShardingSpecError` naming the
    parameter — use it in tests to prove a config shards cleanly on a
    given mesh.
    """

    def rule(path, leaf):
        p = _path_str(path)
        spec = _param_spec(p, tuple(leaf.shape), mesh, cfg)
        return sanitize_spec(spec, tuple(leaf.shape), mesh,
                             strict=strict, path=p)

    return _map_with_path(rule, params_or_shapes)


def batch_specs(batch: Any, mesh) -> Any:
    """Batch dim over (pod, data); everything else replicated."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def rule(_path, leaf):
        nd = len(leaf.shape)
        if not nd:
            return P()
        return sanitize_spec(P(dp, *([None] * (nd - 1))), tuple(leaf.shape),
                             mesh, strict=False)

    return _map_with_path(rule, batch)


def cache_batch_dim(path: str, ndim: int) -> int | None:
    """The batch dim of the decode-cache leaf at ``path`` (``a/b/c``) with
    ``ndim`` dims: 1 under a stacked group or layer dim, 0 otherwise; None
    for a 0-d leaf (``pos``).  :func:`cache_specs` splits this dim over the
    data axes, and the sharded serve step decodes a block of its rows."""
    if ndim == 0:
        return None
    stacked = path.startswith(("groups", "layers")) or "/groups/" in path
    return 1 if stacked else 0


def cache_specs(cache: Any, mesh, cfg) -> Any:
    """Decode-cache specs: batch over data axes, head/channel dim over model.

    Cache leaf layouts (leading group dim G when stacked):
      kv        (G, B, C, Hkv, hd)
      rglru h   (G, B, D)          rglru conv (G, B, 3, D)
      ssm state (G, B, H, P, N)    ssm conv   (G, B, cw-1, ch)
      enc_out   (B, F, D)
      pos       ()
    """
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def rule(path, leaf):
        p = _path_str(path)
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        stacked = cache_batch_dim(p, nd) == 1
        lead = (None,) if stacked else ()
        body = leaf.shape[1:] if stacked else leaf.shape
        bn = len(body)
        if p.endswith("enc_out"):
            spec = P(dp, None, None)
        elif bn == 4 and p.split("/")[-1] in ("k", "v"):
            # (B, C, Hkv, hd): shard heads over model when divisible,
            # otherwise shard the cache sequence dim
            tp_sz = mesh.shape.get("model", 1)
            if body[2] % tp_sz == 0:
                spec = P(*(lead + (dp, None, "model", None)))
            else:
                spec = P(*(lead + (dp, "model", None, None)))
        elif bn == 4:                                        # ssm state (B,H,P,N)
            spec = P(*(lead + (dp, "model", None, None)))
        elif bn == 3:                                        # conv buffers
            spec = P(*(lead + (dp, None, "model")))
        elif bn == 2:                                        # rglru h (B,D)
            spec = P(*(lead + (dp, "model")))
        else:
            spec = P(*(lead + (dp,) + (None,) * (bn - 1)))
        return sanitize_spec(spec, tuple(leaf.shape), mesh,
                             strict=False, path=p)

    return _map_with_path(rule, cache)


# --------------------------------------------------------------------------
# In-model sharding hints
# --------------------------------------------------------------------------

BATCH = ("pod", "data")  # logical batch axes


def shard_hint(x, *axes):
    """The reference's ``with_sharding_constraint`` hint, which places an
    activation across the mesh.  In the port a position's activations are
    whole local tensors of its own program (the sharded steps split the
    batch and gather the weights around the model), so there is nothing
    to place: this is the identity, on a mesh or off it, and model code
    can sprinkle hints without caring about the execution context."""
    del axes
    return x


# --------------------------------------------------------------------------
# The ambient mesh
# --------------------------------------------------------------------------

_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Within this context ``mesh`` is the ambient mesh
    (:func:`current_mesh`), as ``jax.sharding.use_mesh`` makes it in the
    reference; the previous one comes back on exit.  Per thread: the
    threads of :func:`shard_map` set their own."""
    stack = getattr(_AMBIENT, "stack", None)
    if stack is None:
        stack = _AMBIENT.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh():
    """The ambient mesh, or None outside :func:`use_mesh`."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


# --------------------------------------------------------------------------
# Shardings and placed arrays
# --------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a partition spec: where each position's shard of an array
    comes from (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    def __post_init__(self):
        object.__setattr__(self, "spec", P(*self.spec))

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self) -> int:
        return hash((id(self.mesh), tuple(self.spec)))

    def _axes(self, d: int) -> tuple:
        entry = self.spec[d] if d < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def parts(self, d: int) -> int:
        """How many shards dim ``d`` is split into."""
        n = 1
        for a in self._axes(d):
            n *= self.mesh.shape[a]
        return n

    def shard_shape(self, shape) -> tuple:
        """The local shape of an array of ``shape`` on every position."""
        out = []
        for d, n in enumerate(shape):
            k = self.parts(d)
            if n % k:
                raise ShardingSpecError(
                    f"{self.spec!r} splits dim {d} (size {n}) into {k} "
                    f"shards, which does not divide it")
            out.append(n // k)
        return tuple(out)

    def block(self, position: int, ndim: int) -> tuple:
        """The position's shard index along every dim: the coordinates of
        the dim's axes in mixed radix, the first axis major (the
        reference's order for a tuple of axes)."""
        coords = self.mesh.coords(position)
        out = []
        for d in range(ndim):
            i = 0
            for a in self._axes(d):
                i = i * self.mesh.shape[a] + coords[a]
            out.append(i)
        return tuple(out)

    def local(self, full, position: int):
        """The position's shard of the whole array ``full`` (a view)."""
        return self.local_block(full, self.block(position, full.dim()))

    def local_block(self, full, block: tuple):
        """The shard of block index ``block`` of the whole array ``full``
        (a view)."""
        t = full
        for d, (i, n) in enumerate(zip(block, self.shard_shape(full.shape))):
            if n != full.shape[d]:
                t = t.narrow(d, i * n, n)
        return t


def _is_spec(x) -> bool:
    return isinstance(x, P) or x is None


def _map_leaves(fn: Callable, tree: Any, *rest, leaf=None) -> Any:
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples; a
    :class:`P`, a :class:`NamedSharding`, None and anything with
    ``.shape`` are leaves), ``rest`` nested alike."""
    is_leaf = leaf or (lambda x: isinstance(x, (P, NamedSharding))
                       or x is None or hasattr(x, "shape"))
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest), leaf=leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, *(r[i] for r in rest),
                                      leaf=leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_shardings(params_or_shapes: Any, mesh, cfg) -> Any:
    """:func:`param_specs` as :class:`NamedSharding` leaves."""
    return as_shardings(param_specs(params_or_shapes, mesh, cfg), mesh)


def as_shardings(specs: Any, mesh) -> Any:
    """Partition-spec tree -> :class:`NamedSharding` tree; ``None`` leaves
    pass through."""
    return _map_leaves(lambda s: s if s is None else NamedSharding(mesh, s),
                       specs, leaf=_is_spec)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class PlacedArray:
    """An array placed on a mesh: its :class:`NamedSharding` and one local
    tensor per position (``shards``, in position order, each on its
    position's device and of the sharding's local shape).  Positions that
    hold the same block hold equal tensors of their own.  The reference's
    ``jax.Array`` with a sharding: :meth:`gather` / ``numpy()`` give the
    whole array.  On a mesh split over ranks a rank holds its own
    positions' shards only; the other slots are None and never touched."""

    def __init__(self, sharding: NamedSharding, shape, shards: list):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.shards = list(shards)
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{sharding.mesh.size} positions")

    def local_shards(self) -> dict:
        """{position: shard} of the positions this process holds."""
        return {p: s for p, s in enumerate(self.shards) if s is not None}

    def _first_local(self):
        return next(s for s in self.shards if s is not None)

    @property
    def dtype(self):
        return self._first_local().dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def blocks(self) -> dict:
        """{block index: the first position holding it}, in position
        order: one entry for every distinct shard."""
        out: dict = {}
        for p in range(len(self.shards)):
            out.setdefault(self.sharding.block(p, self.ndim), p)
        return out

    def block_shards(self, keep: Callable | None = None) -> dict:
        """{block index: its shard} for every distinct block (those
        ``keep(block)`` accepts), each from its first holder.  On a mesh
        split over ranks a collective that every rank calls alike: a block
        every rank holds is read where it lies, and the others come from
        their first holders through :func:`~repro_torch.distributed.
        collectives.exchange` (every block does on a mesh of one rank; on
        one process nothing moves)."""
        from .collectives import exchange
        firsts = {b: p for b, p in self.blocks().items()
                  if keep is None or keep(b)}
        mesh = self.sharding.mesh
        held: dict = {}
        for q in range(len(self.shards)):
            held.setdefault(self.sharding.block(q, self.ndim),
                            set()).add(mesh.rank_of(q))
        near = {}
        for q in mesh.local_positions:
            near.setdefault(self.sharding.block(q, self.ndim), q)
        moved = [b for b in firsts
                 if mesh.world == 1 or len(held[b]) < mesh.world]
        out = {b: self.shards[near[b]] for b in firsts if b not in moved}
        if moved:
            got = exchange(
                mesh, {firsts[b]: self.shards[firsts[b]] for b in moved
                       if mesh.is_local(firsts[b])},
                [firsts[b] for b in moved], ranks=range(mesh.world),
                like=self._first_local())
            out.update(zip(moved, got))
        return out

    def gather(self, device=None):
        """The whole array, on ``device`` (this process's first shard's by
        default): each block once (:meth:`block_shards`; a collective on a
        mesh split over ranks, which gives every rank the whole array).
        Under a cost walker it is one all-gather over the spec's axes."""
        import torch

        from ..launch import hlo_analysis
        device = device or self._first_local().device
        full = torch.empty(self.shape, dtype=self.dtype, device=device)
        with hlo_analysis.muted():
            for b, shard in self.block_shards().items():
                self.sharding.local_block(full, b).copy_(shard)
        walker = hlo_analysis.active()
        if walker is not None:
            axes = [a for d in range(self.ndim) for a in self.sharding._axes(d)]
            walker.collective("all-gather", hlo_analysis.tensor_bytes(full),
                              hlo_analysis.group_size(self.sharding.mesh,
                                                      axes))
        return full

    def numpy(self):
        import torch
        t = self.gather(torch.device("cpu"))
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self) -> str:
        return (f"PlacedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r}, mesh={self.sharding.mesh!r})")


def _whole(x):
    """A leaf as a whole tensor (a placed array gathered)."""
    import numpy as np
    import torch
    if isinstance(x, PlacedArray):
        return x.gather()
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def _place_leaf(x, sharding):
    if sharding is None:
        return x
    if isinstance(x, PlacedArray) and x.sharding == sharding:
        return x
    from ..launch import hlo_analysis
    mesh = sharding.mesh
    with hlo_analysis.muted():          # an argument's transfer, not a step's
        full = _whole(x)
        shards = [None] * mesh.size
        for p in mesh.local_positions:
            shards[p] = sharding.local(full, p).to(
                mesh.devices[p], copy=True).contiguous()
        return PlacedArray(sharding, full.shape, shards)


def place(tree: Any, shardings: Any) -> Any:
    """The reference's ``jax.device_put(tree, shardings)``: every leaf
    (numpy array, tensor or placed array) split by its
    :class:`NamedSharding` — one sharding for every leaf, or a tree of
    them mirroring ``tree`` (``None`` leaves stay as they are) — into a
    :class:`PlacedArray` whose shards are fresh tensors on the positions'
    devices.  A leaf already placed by its sharding is kept.  On a mesh
    split over ranks each rank places its own positions' shards of the
    whole leaf it is given."""
    if isinstance(shardings, NamedSharding):
        return _map_leaves(lambda x: _place_leaf(x, shardings), tree)
    return _map_leaves(lambda x, s: _place_leaf(x, s), tree, shardings)


def gather(tree: Any) -> Any:
    """Every placed leaf of ``tree`` as its whole tensor."""
    return _map_leaves(lambda x: x.gather() if isinstance(x, PlacedArray)
                       else x, tree)


# --------------------------------------------------------------------------
# shard_map
# --------------------------------------------------------------------------


def _flat_specs(specs, n: int) -> list:
    """``in_specs`` / ``out_specs`` as one spec tree per argument."""
    if _is_spec(specs):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def _spec_tree(spec, tree):
    """``spec`` broadcast over the leaves of ``tree`` when it is one spec
    (the reference's prefix rule), else the spec tree as it is."""
    if _is_spec(spec):
        return _map_leaves(lambda _: spec, tree)
    return spec


def _local_of(x, spec, mesh, p):
    if spec is None:
        return _whole(x)
    return NamedSharding(mesh, spec).local(_whole(x), p)


def _assemble(locals_: list, spec, mesh):
    """The whole output from every position's local output under
    ``spec`` (position 0's under ``None``)."""
    if spec is None:
        return locals_[0]
    sh = NamedSharding(mesh, spec)
    shape = [n * sh.parts(d) for d, n in enumerate(locals_[0].shape)]
    return PlacedArray(sh, shape, locals_).gather()


def shard_map(f, *, mesh, in_specs, out_specs, **kwargs):
    """The reference's ``shard_map``: ``shard_map(f, ...)(*args)`` splits
    each argument (a tree of arrays) by its ``in_specs`` tree, runs ``f``
    on every position's local shards — one thread a position, in which
    :func:`~repro_torch.distributed.collectives.psum`, ``pmax`` and
    ``all_gather`` over the mesh's axis names reduce across the positions
    in position order — and reassembles the outputs by ``out_specs``
    (each block once, from the first position holding it).  A ``None``
    spec passes a whole value in, and takes position 0's out.
    ``check_vma`` / ``check_rep`` are accepted and ignored, as the
    reference's shim does on the JAX versions without them."""
    kwargs.pop("check_vma", None)
    kwargs.pop("check_rep", None)
    if kwargs:
        raise TypeError(f"shard_map got unexpected arguments {sorted(kwargs)}")
    from .collectives import run_positions
    if mesh.distributed:
        raise NotImplementedError(
            f"shard_map on {mesh!r}: shard_map across ranks is not ported "
            f"yet (ROADMAP.md, Queue 1 item 10 (Multi-card meshes))")

    def mapped(*args):
        specs = _flat_specs(in_specs, len(args))
        local_args = [[_map_leaves(lambda x, sp, p=p: _local_of(x, sp, mesh, p),
                                   a, _spec_tree(sp, a))
                       for a, sp in zip(args, specs)]
                      for p in range(mesh.size)]
        outs = run_positions(mesh, lambda p: f(*local_args[p]))
        if not isinstance(outs[0], tuple):
            return _assemble_tree(outs, out_specs, mesh)
        ospecs = _flat_specs(out_specs, len(outs[0]))
        return tuple(_assemble_tree([o[i] for o in outs], ospecs[i], mesh)
                     for i in range(len(outs[0])))

    return mapped


def _assemble_tree(trees: list, spec, mesh):
    """:func:`_assemble` over the leaves of the positions' output trees;
    one spec applies to every leaf below it."""
    if isinstance(trees[0], dict):
        return {k: _assemble_tree([t[k] for t in trees],
                                  spec[k] if isinstance(spec, dict) else spec,
                                  mesh) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)) and not hasattr(trees[0], "shape"):
        return type(trees[0])(
            _assemble_tree([t[i] for t in trees],
                           spec[i] if isinstance(spec, (list, tuple))
                           and not isinstance(spec, P) else spec, mesh)
            for i in range(len(trees[0])))
    return _assemble(trees, spec, mesh)
