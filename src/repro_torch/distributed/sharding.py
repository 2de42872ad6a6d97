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

The reference's placement helpers (``use_mesh``, ``as_shardings``,
``param_shardings``, ``replicated``, the ``shard_map`` shim) place arrays
for GSPMD; they wait for item 7b, whose sharded train step decides how
such placements execute.  :func:`shard_hint` is the identity: the port
has no ambient mesh, and the reference's hint is the identity outside one.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["BATCH", "P", "ShardingSpecError", "batch_specs", "cache_specs",
           "param_specs", "sanitize_spec", "shard_hint"]

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
        stacked = p.startswith(("groups", "layers")) or "/groups/" in p
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
    """The reference's ``with_sharding_constraint`` hint.  Outside a mesh
    the reference's is the identity, and the port has no ambient mesh, so
    this is the identity: model code can sprinkle hints without caring
    about the execution context."""
    del axes
    return x
