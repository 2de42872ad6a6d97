"""Transformer layer library of the PyTorch port: norms, RoPE, GQA/MQA
attention (blockwise, sliding-window, KV-cache), gated/plain FFN, MoE,
embeddings.

The port's copy of ``repro/models/layers.py``.  Everything is functional:
parameters are nested dicts of tensors with the reference's key paths, so
a parameter tree crosses between the packages by path
(:func:`repro_torch.models.params_from_numpy`).  Where the reference takes
a PRNG key an initializer here takes a ``torch.Generator`` and draws from
it in order; tensors are made on the generator's device (a ``None``
generator draws from the default one, as under ``torch.device("meta")``).

Long-sequence attention is *blockwise with online softmax* (the
flash-attention recurrence) as nested loops over (q blocks × kv blocks):
the memory-bounded form, with the reference's ``-1e30`` mask value and
``max(l, 1e-30)`` guard.  The decode step writes its KV cache in place
(the reference donates the cache to ``jax.jit``), clamping the slot as
``lax.dynamic_update_slice`` clamps its start, on the device.

The ``REPRO_*`` switches are read at import, as in the reference:
``REPRO_ATTN_OPT``, ``REPRO_ATTN_SEQSHARD``, ``REPRO_MOE_BF16DISPATCH`` and
``REPRO_MOE_CHUNK`` change the forward; ``REPRO_BF16_BWD`` changes only
the gradients that training takes through ``linear`` and ``unembed``
(:func:`dot_bf16bwd`).

**Tensor-parallel forms.**  Inside a sharded step a parameter leaf split
over ``model`` arrives as :class:`~repro_torch.distributed.spmd.Shards`
(one part a model position, ``distributed/spmd.py``), and each function
here that reads one runs the reference's GSPMD layout of its work: each
position computes with its part (:func:`~repro_torch.distributed.spmd.
per_position`), and the partial results meet in the group collectives
of ``distributed/collectives.py``.  Attention splits its query heads
(KV heads where ``n_kv_heads`` divides; otherwise K/V are computed whole
on every position, and a decode cache split over its sequence is read
as partial softmaxes combined by ``group_pmax`` / ``group_psum``), the
FFN its ``d_ff``, MoE its experts (or its ``d_ff`` with fewer experts
than positions; the router and the dispatch are every position's), the
embedding and the head their vocab (a vocab-parallel lookup and
cross-entropy); a row-parallel output is summed over ``model`` in
position order.  Outside a mesh every function is the plain form,
unchanged.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.collectives import (charge_backward, group_all_gather,
                                       group_pmax, group_psum)
from ..distributed.spmd import Shards, per_position

Params = dict

# --- §Perf hillclimb switches (read at import, as the reference reads them
# at trace time).  See repro/models/layers.py for what each one trades.
# REPRO_ATTN_OPT repeats the KV heads to the query heads; in the
# tensor-parallel form each model position repeats its own KV heads to its
# query heads, so the merged heads are split over `model`.
# REPRO_ATTN_SEQSHARD groups the q blocks of blockwise attention: in the
# tensor-parallel form each model position sweeps the q blocks o·P + p of
# its index p over every head (queries, keys and values gathered over
# `model`), and the outputs are gathered back before `wo`; off a mesh P = 1
# and the loop is the plain one.
_ATTN_OPT = os.environ.get("REPRO_ATTN_OPT", "0") == "1"
_ATTN_SEQSHARD = os.environ.get("REPRO_ATTN_SEQSHARD", "0") == "1"
_MOE_BF16 = os.environ.get("REPRO_MOE_BF16DISPATCH", "0") == "1"
_MOE_CHUNK = int(os.environ.get("REPRO_MOE_CHUNK", "0"))
# REPRO_BF16_BWD=1  cast matmul cotangents to the weight dtype before the
#                   backward products (the reference's custom VJP).
_BF16_BWD = os.environ.get("REPRO_BF16_BWD", "0") == "1"

_DOT = None


def _dot_function():
    """The ``torch.autograd.Function`` of :func:`dot_bf16bwd`."""
    global _DOT
    if _DOT is None:
        class DotBf16Bwd(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w):
                ctx.save_for_backward(x, w)
                return x @ w

            @staticmethod
            def backward(ctx, g):
                x, w = ctx.saved_tensors
                gb = g.to(w.dtype)
                dx = torch.einsum("...f,df->...d", gb, w)
                ct = torch.promote_types(x.dtype, gb.dtype)
                dw = torch.einsum("...d,...f->df", x.to(ct), gb.to(ct))
                return dx.to(x.dtype), dw.to(w.dtype)

        _DOT = DotBf16Bwd
    return _DOT


def dot_bf16bwd(x, w):
    """``x @ w`` whose backward casts the cotangent to ``w``'s dtype
    before both products (``repro/models/layers.py: dot_bf16bwd``)."""
    return _dot_function().apply(x, w)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nest of dicts (and of ``rest``, nested
    alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str) -> dict:
    """The leaves of a nest of dicts by path (``prefix/key/...``): the env
    of a captured step over the tree."""
    if isinstance(tree, dict):
        return {path: leaf for k, v in tree.items()
                for path, leaf in tree_paths(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def tree_from_paths(tree, scope: dict, prefix: str):
    """``tree`` rebuilt from the leaves of ``scope`` at its paths."""
    if isinstance(tree, dict):
        return {k: tree_from_paths(v, scope, f"{prefix}/{k}")
                for k, v in tree.items()}
    return scope[prefix]


def _device(g):
    return g.device if g is not None else None


def _normal(g, shape, scale: float, dtype):
    """A float32 standard normal draw times ``scale``, cast to ``dtype``
    (the reference's ``(normal(key, shape) * scale).astype(dtype)``)."""
    x = torch.randn(shape, generator=g, device=_device(g),
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------------
# Initializers / linear
# --------------------------------------------------------------------------


def dense_init(g, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(g, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=_device(g))
    return p


def _split(t) -> bool:
    """``t`` is a leaf split over ``model`` (a tensor-parallel form runs)."""
    return isinstance(t, Shards) and t.axis == "model"


def _part(p: Params, m: int) -> Params:
    """Model position ``m``'s parameters of a unit tree: each leaf split
    over ``model`` as its part ``m``, the others as they are, but the bias
    of a weight whose output columns are split, which ``param_specs``
    leaves whole (a 1-D leaf), as the position's columns."""
    if not isinstance(p, dict):
        return p.parts[m] if _split(p) else p
    out = {k: _part(v, m) for k, v in p.items()}
    w = p.get("w")
    if "b" in p and _split(w) and w.dim == out["w"].dim() - 1 \
            and not _split(p["b"]):
        k = out["w"].shape[-1]
        out["b"] = p["b"][..., m * k:(m + 1) * k]
    return out


class _Fan:
    """An activation that the ``n`` model positions read.  A low-precision
    one that a gradient flows back through is held as one float32 copy
    (``shared``): the positions' products take it as it is
    (:func:`linear_part`), so their gradients meet there in float32 and
    are rounded once, as one unsplit product accumulates them; that sum
    is an all-reduce over ``model``, charged to the cost walker when
    autograd computes it.  Calling it gives the activation in its own
    dtype, for the other reads."""

    __slots__ = ("dtype", "shared")

    def __init__(self, x, n: int):
        self.dtype = x.dtype
        low = x.dtype in (torch.bfloat16, torch.float16)
        self.shared = x.float() if x.requires_grad and low else x
        charge_backward("all-reduce", self.shared, n)

    def __call__(self):
        return self.shared.to(self.dtype)


def _dot32(a, b):
    """``a @ b`` in float32, unrounded: on the card cuBLAS's float32
    output of the low-precision operands (``aten::mm.dtype``), elsewhere
    the product of their float32 copies (exact products, float32 sums)."""
    if a.dtype == b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    out = torch.ops.aten.mm.dtype(a.reshape(-1, a.shape[-1]), b,
                                  torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


_PART_DOT = None


def _part_dot_function():
    """The ``torch.autograd.Function`` of :func:`linear_part`."""
    global _PART_DOT
    if _PART_DOT is None:
        class PartDot(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w):
                xl = x.to(w.dtype)
                ctx.save_for_backward(xl, w)
                ctx.x_dtype = x.dtype
                return xl @ w

            @staticmethod
            def backward(ctx, g):
                xl, w = ctx.saved_tensors
                gl = g.to(w.dtype)
                dx = dw = None
                if ctx.needs_input_grad[0]:
                    dx = (_dot32(gl, w.T) if ctx.x_dtype != w.dtype
                          else gl @ w.T).to(ctx.x_dtype)
                if ctx.needs_input_grad[1]:
                    dw = torch.einsum("...d,...f->df", xl, gl)
                return dx, dw

        _PART_DOT = PartDot
    return _PART_DOT


def linear_part(p: Params, x):
    """A model position's ``linear`` of a weight whose columns (its
    output) are split: ``x`` a tensor or a :class:`_Fan` (its float32 copy
    taken, so the input's gradient comes back in float32 and the
    positions' partials are summed before one rounding).  The cotangent
    is cast to the weight's dtype before the backward products, as
    ``x @ w``'s is."""
    if isinstance(p["w"], Shards):      # REPRO_DECODE_WSTAT's data shards
        y = _mm(x() if isinstance(x, _Fan) else x, p["w"])
    else:
        xs = x.shared if isinstance(x, _Fan) else x
        y = _part_dot_function().apply(xs, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


_ROW = None


def _row_functions():
    """The ``torch.autograd.Function`` classes of :func:`row_linear`: ``Hold``
    (the identity on x, holding x and w for the backward) and ``RowDot``
    (x @ w in float32, unrounded, reading them from its ``Hold``)."""
    global _ROW
    if _ROW is None:
        class Hold(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w):
                ctx.save_for_backward(x, w)
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return g, None

        class RowDot(torch.autograd.Function):
            @staticmethod
            def forward(ctx, held, w):
                ctx.hold = held.grad_fn
                return _dot32(held, w)

            @staticmethod
            def backward(ctx, g):
                x, w = ctx.hold.saved_tensors
                gl = g.to(w.dtype)
                return gl @ w.T, torch.einsum("...d,...f->df", x, gl)

        _ROW = (Hold, RowDot)
    return _ROW


def row_linear(ps: list, ys: list, dtype):
    """``Σ_m ys[m] @ ps[m]["w"]`` over the model positions, for a weight
    whose rows (its input) are split: each position's partial product in
    float32, unrounded, summed in position order (``group_psum``, an
    all-reduce over ``model``) and rounded once to ``dtype``, as one
    unsplit product rounds its sum.  Every position's operands are held
    for the backward before any product runs, so the recompute of a
    checkpointed region stops before the products, as it stops before an
    unsplit product (whose operands are saved before it runs)."""
    n, like = len(ps), ys[0]
    ws = [p["w"] for p in ps]
    if isinstance(ws[0], Shards):       # REPRO_DECODE_WSTAT's data shards
        parts = per_position(n, lambda m: _mm(ys[m], ws[m]).float(), like)
    elif not (torch.is_grad_enabled()
              and (like.requires_grad or ws[0].requires_grad)):
        parts = per_position(n, lambda m: _dot32(ys[m], ws[m]), like)
    else:
        hold, row_dot = _row_functions()
        held = per_position(n, lambda m: hold.apply(ys[m], ws[m]), like)
        parts = per_position(n, lambda m: row_dot.apply(held[m], ws[m]),
                             like)
    return group_psum(parts).to(dtype)


def _mm(x, w):
    """``x @ w``; a weight left where it lies over ``data`` (the
    weight-stationary decode) contracts each FSDP shard on its position:
    split rows give partial sums, summed over ``data``; split columns give
    the position's columns, gathered over ``data``."""
    if isinstance(w, Shards):
        if w.dim == 0:
            k = w.parts[0].shape[0]
            return group_psum(per_position(
                w.n, lambda j: _mm(x[..., j * k:(j + 1) * k], w.parts[j]),
                w))
        return group_all_gather(per_position(
            w.n, lambda j: _mm(x, w.parts[j]), w), -1)
    return dot_bf16bwd(x, w) if _BF16_BWD else x @ w


def linear(p: Params, x):
    y = _mm(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d: int, kind: str, dtype, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf ** 2).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def activation(x, act: str):
    if act in ("silu", "swish"):
        return F.silu(x)
    if act in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if act == "relu":
        return F.relu(x)
    raise ValueError(act)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].float() * freqs            # (..., S, hd/2)
    ang = ang[..., None, :]                               # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def init_attention(g, cfg: ArchConfig, d_model: int | None = None) -> Params:
    d = d_model or cfg.d_model
    dt = cfg.tdtype
    return {
        "wq": dense_init(g, d, cfg.q_dim, dt, bias=cfg.qkv_bias),
        "wk": dense_init(g, d, cfg.kv_dim, dt, bias=cfg.qkv_bias),
        "wv": dense_init(g, d, cfg.kv_dim, dt, bias=cfg.qkv_bias),
        "wo": dense_init(g, cfg.q_dim, d, dt),
    }


def _qkv(p: Params, x, cfg: ArchConfig):
    B, S, _ = x.shape
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _kv_sweep(qtile, q_pos, kb, vb, *, causal: bool, window: int,
              scale: float):
    """The online softmax of ``qtile`` (P, B, Hkv, G, bq, hd) at positions
    ``q_pos`` (P, bq) over the key blocks ``kb``/``vb`` (nk, B, Hkv, bk,
    hd), in float32: the reference's inner ``lax.scan`` as a loop."""
    P, B, Hkv, G, bq, hd = qtile.shape
    nk, bk = kb.shape[0], kb.shape[3]
    dev = qtile.device
    qf = qtile.float()
    m = torch.full((P, B, Hkv, G, bq), -1e30, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((P, B, Hkv, G, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((P, B, Hkv, G, bq, hd), dtype=torch.float32,
                      device=dev)
    k_pos_base = torch.arange(bk, device=dev)
    for ki in range(nk):
        k_pos = ki * bk + k_pos_base                              # (bk,)
        s = torch.einsum("pbhgqd,bhkd->pbhgqk", qf, kb[ki].float()) * scale
        mask = torch.ones((P, bq, bk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, :, None] >= k_pos[None, None, :]
        if window:
            mask &= q_pos[:, :, None] - k_pos[None, None, :] < window
        s = torch.where(mask[:, None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "pbhgqk,bhkd->pbhgqd", p, vb[ki].float())
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_offset: int = 0, block_q: int = 512,
                        block_k: int = 1024):
    """Flash-style online-softmax attention in plain PyTorch ops.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd) with Hq = G·Hkv.
    Nested loops over (q blocks × kv blocks) keep live memory at
    O(B·H·bq·bk) regardless of sequence length.
    """
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if _ATTN_OPT and Hq > Hkv:
        # repeat KV to query heads (jnp.repeat: each head in place, rep
        # times)
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        Hkv = Hq
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = Sq // bq, Sk // bk
    if Sq % bq or Sk % bk:
        raise ValueError(f"blocks must divide the sequences: Sq={Sq}, "
                         f"bq={bq}, Sk={Sk}, bk={bk}")

    qb = q.reshape(B, nq, bq, Hkv, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)

    q_pos_base = torch.arange(bq, device=q.device)
    out = torch.stack([
        _kv_sweep(qb[qi][None], (q_offset + qi * bq + q_pos_base)[None],
                  kb, vb, causal=causal, window=window, scale=scale)[0]
        for qi in range(nq)])
    # out: (nq, B, Hkv, G, bq, hd) -> (B, Sq, Hq, hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_positions=None, k_positions=None):
    """Unblocked reference (small S / decode).  Same signature semantics."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(hd)
    qp = q_positions if q_positions is not None else torch.arange(
        Sq, device=q.device)
    kp = k_positions if k_positions is not None else torch.arange(
        Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window:
        mask &= qp[:, None] - kp[None, :] < window
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def _kv_for_heads(k, v, h0: int, hq: int, n_heads: int):
    """Whole K / V (every KV head, which do not divide over the positions)
    as the query heads ``h0:h0 + hq`` of ``n_heads`` read them: MQA's one
    head as it is, else repeated to the query heads and sliced."""
    hkv = k.shape[2]
    if hkv == 1:
        return k, v
    g = n_heads // hkv
    return (k.repeat_interleave(g, dim=2)[:, :, h0:h0 + hq],
            v.repeat_interleave(g, dim=2)[:, :, h0:h0 + hq])


def _blockwise_groups(q, k, v, *, causal: bool, window: int, n: int,
                      block_q: int = 512, block_k: int = 1024):
    """:func:`blockwise_attention` with its q blocks grouped over ``n``
    model positions (``REPRO_ATTN_SEQSHARD``): position ``p`` sweeps the q
    blocks ``o·n + p`` over every head, and the outputs are gathered over
    ``model`` back into sequence order."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if _ATTN_OPT and Hq > Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
        Hkv = Hq
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = Sq // bq, Sk // bk
    qb = q.reshape(B, nq, bq, Hkv, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, bk, Hkv, hd).permute(1, 0, 3, 2, 4)
    base = torch.arange(bq, device=q.device)
    take_k, take_v = _Fan(kb, n), _Fan(vb, n)

    def group(m):
        qi = torch.arange(m, nq, n, device=q.device)
        return _kv_sweep(qb[m::n], qi[:, None] * bq + base[None], take_k(),
                         take_v(), causal=causal, window=window, scale=scale)

    outs = per_position(n, group, q)
    out = group_all_gather([o.unsqueeze(1) for o in outs], 1)
    out = out.reshape(nq, B, Hkv, G, bq, hd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, Hq, hd).to(q.dtype)


def _attend(q, k, v, *, causal: bool, window: int):
    """Blockwise attention past 2048 positions, else the full one."""
    if q.shape[1] > 2048:
        return blockwise_attention(q, k, v, causal=causal, window=window)
    return full_attention(q, k, v, causal=causal, window=window)


def _attention_train_tp(p: Params, x, cfg: ArchConfig, *, causal: bool,
                        window: int, positions):
    """:func:`attention_train` on a unit's shards: query heads (and KV
    heads where they divide) split over ``model``, ``wo``'s rows split and
    its output summed over ``model``."""
    B, S, _ = x.shape
    n, hd = p["wq"]["w"].n, cfg.hd
    hq = cfg.n_heads // n
    kv_split = _split(p["wk"]["w"])
    hkv = cfg.n_kv_heads // n if kv_split else cfg.n_kv_heads
    pos = positions if positions is not None else torch.arange(
        S, device=x.device)[None]

    def rope(t):
        return apply_rope(t, pos, cfg.rope_theta) if cfg.pos == "rope" else t

    take = _Fan(x, n)

    def q_of(m):
        return rope(linear_part(_part(p, m)["wq"], take).reshape(
            B, S, hq, hd))

    def kv_of(m):
        pm = _part(p, m)
        return (rope(linear_part(pm["wk"], take).reshape(B, S, hkv, hd)),
                linear_part(pm["wv"], take).reshape(B, S, hkv, hd))

    if not kv_split:
        k_all = rope(linear(p["wk"], x).reshape(B, S, hkv, hd))
        v_all = linear(p["wv"], x).reshape(B, S, hkv, hd)
        take_k, take_v = _Fan(k_all, n), _Fan(v_all, n)

    if S > 2048 and _ATTN_SEQSHARD and (S // min(512, S)) % n == 0:
        q = group_all_gather(per_position(n, q_of, x), 2)
        if kv_split:
            kvs = per_position(n, kv_of, x)
            k_all = group_all_gather([k for k, _ in kvs], 2)
            v_all = group_all_gather([v for _, v in kvs], 2)
        o = _blockwise_groups(q, k_all, v_all, causal=causal, window=window,
                              n=n)
        os_ = [o[:, :, m * hq:(m + 1) * hq] for m in range(n)]
    else:
        def one(m):
            k, v = kv_of(m) if kv_split else _kv_for_heads(
                take_k(), take_v(), m * hq, hq, cfg.n_heads)
            return _attend(q_of(m), k, v, causal=causal, window=window)

        os_ = per_position(n, one, x)
    return row_linear([_part(p, m)["wo"] for m in range(n)],
                      [o.reshape(B, S, hq * hd) for o in os_], x.dtype)


def attention_train(p: Params, x, cfg: ArchConfig, *, causal: bool = True,
                    window: int = 0, positions=None):
    if _split(p["wq"]["w"]):
        return _attention_train_tp(p, x, cfg, causal=causal, window=window,
                                   positions=positions)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.pos == "rope":
        pos = positions if positions is not None else torch.arange(
            S, device=x.device)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = _attend(q, k, v, causal=causal, window=window)
    return linear(p["wo"], o.reshape(B, S, cfg.q_dim))


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, layers: int,
                  dtype=None, device=None) -> Params:
    """A stacked KV cache on ``device`` (the card when it is None)."""
    from ..api import resolve_device
    device = resolve_device(device)
    dt = dtype or cfg.tdtype
    shape = (layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_positions(C: int, pos, window: int, device):
    """The absolute position each of the ``C`` cache slots holds at step
    ``pos`` (ring-aware), -1 for a slot that holds none."""
    slots = torch.arange(C, device=device)
    if window > 0:
        # absolute position stored in slot s: the largest p <= pos with
        # p % C == s
        kpos = pos - torch.remainder(pos - slots, C)
        valid = kpos >= torch.clamp(pos - window + 1, min=0)
        return torch.where(valid, kpos, -1)
    return torch.where(slots <= pos, slots, -1)


def _decode_attend(q, k_cache, v_cache, kpos, hd: int):
    """One query token's softmax attention over a whole cache: q (B, 1,
    Hq, hd) against (B, C, Hkv, hd); (B, 1, Hq·hd) float32."""
    B, _, Hq, _ = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k_cache.float()) / math.sqrt(hd)
    s = torch.where((kpos >= 0)[None, None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v_cache.float())
    return o.reshape(B, 1, Hq * hd)


def attention_decode(p: Params, x, cfg: ArchConfig, *, k_cache, v_cache,
                     pos, window: int = 0):
    """One-token decode.  x: (B, 1, D); caches: (B, C, Hkv, hd); pos: ()
    current absolute position (a device tensor).  Returns (y, k_cache,
    v_cache), the caches written in place.

    With a sliding window the cache is a ring buffer of length C=window;
    otherwise C >= seq_len and slot = pos, clamped to C-1 as
    ``lax.dynamic_update_slice`` clamps its start (no host read, so the
    step can be captured).
    """
    if _split(p["wq"]["w"]) or isinstance(k_cache, Shards):
        return _attention_decode_tp(p, x, cfg, k_cache=k_cache,
                                    v_cache=v_cache, pos=pos, window=window)
    C = k_cache.shape[1]
    q, k, v = _qkv(p, x, cfg)
    if cfg.pos == "rope":
        q = apply_rope(q, pos[None, None], cfg.rope_theta)
        k = apply_rope(k, pos[None, None], cfg.rope_theta)
    o = _write_attend(q, k, v, k_cache, v_cache, _slot(pos, C, window),
                      _cache_positions(C, pos, window, x.device), cfg.hd)
    return linear(p["wo"], o.to(x.dtype)), k_cache, v_cache


def _slot(pos, C: int, window: int):
    """The cache slot of ``pos``: a ring buffer's with a window, clamped to
    the cache as ``lax.dynamic_update_slice`` clamps its start."""
    slot = pos % max(C, 1) if window > 0 else pos
    return torch.clamp(slot, 0, C - 1).reshape(1).long()


def _write_attend(q, k, v, k_cache, v_cache, slot, kpos, hd: int):
    """Write the token's K / V into the cache at ``slot``, in place, and
    attend over the cache."""
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    return _decode_attend(q, k_cache, v_cache, kpos, hd)


def _attention_decode_tp(p: Params, x, cfg: ArchConfig, *, k_cache,
                         v_cache, pos, window: int):
    """:func:`attention_decode` on a unit's shards and the cache where it
    lies.  With the cache's KV heads split over ``model`` each position
    decodes its heads against its own cache.  Otherwise K/V are computed
    whole, the queries gathered over ``model``, and each position's cache
    rows (the sequence split over ``model``, or the whole cache) give a
    partial softmax (m, l, acc), combined by ``group_pmax`` and
    ``group_psum``; the output's heads then meet ``wo``'s rows."""
    B, hd = x.shape[0], cfg.hd
    q_split = _split(p["wq"]["w"])
    n = p["wq"]["w"].n if q_split else k_cache.n
    hq = cfg.n_heads // n if q_split else cfg.n_heads
    rp = pos[None, None]

    def rope(t):
        return apply_rope(t, rp, cfg.rope_theta) if cfg.pos == "rope" else t

    by_rows = not (isinstance(k_cache, Shards) and k_cache.dim == 2)
    holders = (k_cache.parts if isinstance(k_cache, Shards) else [k_cache],
               v_cache.parts if isinstance(v_cache, Shards) else [v_cache])
    cm = holders[0][0].shape[1]
    C = cm * (len(holders[0]) if by_rows else 1)
    slot = _slot(pos, C, window)
    kpos = _cache_positions(C, pos, window, x.device)

    if not by_rows:
        hkv = cfg.n_kv_heads // n

        def one(m):
            pm = _part(p, m)
            q = rope(linear_part(pm["wq"], x).reshape(B, 1, hq, hd))
            k = rope(linear_part(pm["wk"], x).reshape(B, 1, hkv, hd))
            v = linear_part(pm["wv"], x).reshape(B, 1, hkv, hd)
            return _write_attend(q, k, v, k_cache.parts[m], v_cache.parts[m],
                                 slot, kpos, hd).to(x.dtype)

        return (row_linear([_part(p, m)["wo"] for m in range(n)],
                           per_position(n, one, x), x.dtype), k_cache,
                v_cache)

    # K/V whole: where the KV heads divide, so do the cache's (cache_specs)
    k = rope(linear(p["wk"], x).reshape(B, 1, cfg.n_kv_heads, hd))
    v = linear(p["wv"], x).reshape(B, 1, cfg.n_kv_heads, hd)
    if q_split:
        q = group_all_gather(per_position(
            n, lambda m: linear_part(_part(p, m)["wq"], x).reshape(
                B, 1, hq, hd),
            x), 2)
    else:
        q = linear(p["wq"], x).reshape(B, 1, cfg.n_heads, hd)
    q = rope(q)
    hkv = cfg.n_kv_heads
    qg = q.reshape(B, 1, hkv, cfg.n_heads // hkv, hd).float()

    def rows(m):
        kc, vc = holders[0][m], holders[1][m]
        local = slot - m * cm
        idx = torch.clamp(local, 0, cm - 1)
        inside = (local >= 0) & (local < cm)
        kc.index_copy_(1, idx, torch.where(inside, k, kc.index_select(1, idx)))
        vc.index_copy_(1, idx, torch.where(inside, v, vc.index_select(1, idx)))
        kp = kpos[m * cm:(m + 1) * cm]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) / math.sqrt(hd)
        s = torch.where((kp >= 0)[None, None, None, None, :], s, -1e30)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        return mx, e.sum(-1, keepdim=True), torch.einsum(
            "bhgqk,bkhd->bhgqd", e, vc.float())

    parts = per_position(len(holders[0]), rows, x)
    mx = group_pmax([a for a, _, _ in parts])
    l = group_psum([s_ * torch.exp(a - mx) for a, s_, _ in parts])
    acc = group_psum([o * torch.exp(a - mx) for a, _, o in parts])
    o = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, 1, cfg.q_dim).to(x.dtype)
    if not q_split:
        return linear(p["wo"], o), k_cache, v_cache
    w = hq * hd
    return (row_linear([_part(p, m)["wo"] for m in range(n)],
                       [o[..., m * w:(m + 1) * w] for m in range(n)],
                       x.dtype), k_cache, v_cache)


def init_cross_attention(g, cfg: ArchConfig) -> Params:
    return init_attention(g, cfg)


def cross_attention(p: Params, x, enc_kv, cfg: ArchConfig):
    """Decoder->encoder attention; enc_kv precomputed (B, F, Hkv, hd), or
    each model position's KV heads (:func:`encode_kv` on shards)."""
    B, S, _ = x.shape
    k, v = enc_kv
    if _split(p["wq"]["w"]):
        n = p["wq"]["w"].n
        hq = cfg.n_heads // n
        take = _Fan(x, n)
        if not isinstance(k, list):
            take_k, take_v = _Fan(k, n), _Fan(v, n)

        def one(m):
            pm = _part(p, m)
            q = linear_part(pm["wq"], take).reshape(B, S, hq, cfg.hd)
            km, vm = ((k[m], v[m]) if isinstance(k, list) else _kv_for_heads(
                take_k(), take_v(), m * hq, hq, cfg.n_heads))
            return full_attention(q, km, vm, causal=False).reshape(
                B, S, hq * cfg.hd)

        return row_linear([_part(p, m)["wo"] for m in range(n)],
                          per_position(n, one, x), x.dtype)
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.hd)
    o = full_attention(q, k, v, causal=False)
    return linear(p["wo"], o.reshape(B, S, cfg.q_dim))


def encode_kv(p: Params, enc_out, cfg: ArchConfig):
    B, Fr, _ = enc_out.shape
    if _split(p["wk"]["w"]):
        n = p["wk"]["w"].n
        hkv = cfg.n_kv_heads // n
        take = _Fan(enc_out, n)
        kv = per_position(n, lambda m: tuple(
            linear_part(_part(p, m)[w], take).reshape(B, Fr, hkv, cfg.hd)
            for w in ("wk", "wv")), enc_out)
        return [k for k, _ in kv], [v for _, v in kv]
    k = linear(p["wk"], enc_out).reshape(B, Fr, cfg.n_kv_heads, cfg.hd)
    v = linear(p["wv"], enc_out).reshape(B, Fr, cfg.n_kv_heads, cfg.hd)
    return k, v


# --------------------------------------------------------------------------
# FFN (dense + MoE)
# --------------------------------------------------------------------------


def init_ffn(g, cfg: ArchConfig, d_ff: int | None = None) -> Params:
    ff = d_ff or cfg.d_ff
    dt = cfg.tdtype
    p = {"w_in": dense_init(g, cfg.d_model, ff, dt),
         "w_out": dense_init(g, ff, cfg.d_model, dt)}
    if cfg.glu:
        p["w_gate"] = dense_init(g, cfg.d_model, ff, dt)
    return p


def _ffn_hidden(p: Params, x, cfg: ArchConfig, lin):
    """The FFN's hidden activation (before ``w_out``), its products by
    ``lin``."""
    h = lin(p["w_in"], x)
    if cfg.glu:
        return activation(lin(p["w_gate"], x), cfg.act) * h
    return activation(h, cfg.act)


def ffn_apply(p: Params, x, cfg: ArchConfig):
    if not _split(p["w_in"]["w"]):
        return linear(p["w_out"], _ffn_hidden(p, x, cfg, linear))
    # d_ff split over `model`; w_out's rows summed
    n = p["w_in"]["w"].n
    take = _Fan(x, n)
    hs = per_position(n, lambda m: _ffn_hidden(_part(p, m), take, cfg,
                                               linear_part), x)
    return row_linear([_part(p, m)["w_out"] for m in range(n)], hs, x.dtype)


def init_moe(g, cfg: ArchConfig) -> Params:
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    E, ff, d, dt = cfg.moe.num_experts, cfg.d_ff, cfg.d_model, cfg.tdtype
    s = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(g, d, E, dt, scale=0.02),
        "w_in": _normal(g, (E, d, ff), s, dt),
        "w_out": _normal(g, (E, ff, d), 1 / math.sqrt(ff), dt),
    }
    if cfg.glu:
        p["w_gate"] = _normal(g, (E, d, ff), s, dt)
    return p


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_dispatch(topi, E: int, C: int):
    """The capacity bookkeeping of one token chunk: ``onehot`` (c, K, E)
    float32, each (token, k)'s slot ``pos`` (c, K) int32 in its expert's
    buffer — a cumsum over the flattened (token, k) order — and ``keep``
    (c, K), the slots below the capacity ``C``."""
    c, K = topi.shape
    onehot = _one_hot(topi, E, torch.float32)                 # (c,K,E)
    flat = onehot.reshape(-1, E)                              # (c*K,E)
    pos_in_e = (torch.cumsum(flat, dim=0) - flat).reshape(c, K, E)
    pos = torch.einsum("cke,cke->ck", pos_in_e, onehot).to(torch.int32)
    return onehot, pos, pos < C


def moe_apply(p: Params, x, cfg: ArchConfig, chunk: int = 1024):
    """Capacity-based dense dispatch, chunked over tokens so the one-hot
    dispatch tensor stays O(chunk · E · C): token blocks stream through
    the expert "tasks" instead of materializing the full routing matrix.
    ``lax.top_k``'s descending order is ``torch.topk``'s."""
    if _MOE_CHUNK:
        chunk = _MOE_CHUNK
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    xt = x.reshape(T, D)
    chunk = min(chunk, T)
    n_chunks = T // chunk
    if T % chunk:
        raise ValueError(f"the MoE chunk {chunk} must divide the {T} tokens")
    C = max(1, int(chunk * K * cfg.moe.capacity_factor / E))

    logits = (xt @ p["router"]["w"]).float()                  # (T, E)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, K, dim=-1, sorted=True)    # (T, K)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    disp_dt = torch.bfloat16 if _MOE_BF16 else torch.float32
    ys = []
    for ci in range(n_chunks):
        rows = slice(ci * chunk, (ci + 1) * chunk)
        xc, wc, ic = xt[rows], topw[rows], topi[rows]
        onehot, pos, keep = moe_dispatch(ic, E, C)
        sel = onehot * keep[..., None]
        # dispatch tensor (c, E, C): {0,1}-valued, exact in bf16
        disp = torch.einsum("cke,ckp->cep", sel.to(disp_dt),
                            _one_hot(pos, C, disp_dt))
        xe = torch.einsum("cep,cd->epd", disp, xc.to(disp_dt)).to(xc.dtype)
        comb = torch.einsum("cke,ckp,ck->cep", sel,
                            _one_hot(pos, C, torch.float32), wc.float())
        if _split(p["w_in"]):
            yc = _moe_experts_tp(p, xe, comb, cfg)
        else:
            ye = _experts(p, xe, cfg)
            yc = torch.einsum("cep,epd->cd", comb, ye.float())
        ys.append(yc.to(xc.dtype))
    return torch.cat(ys).reshape(B, S, D)


def _experts(p: Params, xe, cfg: ArchConfig):
    """The expert FFNs of the banks in ``p`` on their buffers ``xe`` (E, C,
    D)."""
    h = torch.einsum("epd,edf->epf", xe, p["w_in"])
    if cfg.glu:
        gt = torch.einsum("epd,edf->epf", xe, p["w_gate"])
        h = activation(gt, cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return torch.einsum("epf,efd->epd", h, p["w_out"])


def _moe_experts_tp(p: Params, xe, comb, cfg: ArchConfig):
    """A chunk's combined expert outputs (c, D) float32 on a unit's
    shards: each model position runs its experts (the expert dim split)
    or its ``d_ff`` columns of every expert, combines them, and the
    partial outputs are summed over ``model``."""
    w = p["w_in"]
    n = w.n
    if w.dim == 0:
        el = xe.shape[0] // n

        def one(m):
            sl = slice(m * el, (m + 1) * el)
            ye = _experts(_part(p, m), xe[sl], cfg)
            return torch.einsum("cep,epd->cd", comb[:, sl], ye.float())
    else:
        take = _Fan(xe, n)

        def one(m):
            ye = _experts(_part(p, m), take(), cfg)
            return torch.einsum("cep,epd->cd", comb, ye.float())
    return group_psum(per_position(n, one, xe))


def moe_aux_loss(logits, topi, E: int):
    """Load-balancing auxiliary loss (Switch-style)."""
    gates = torch.softmax(logits.float(), dim=-1)
    me = gates.mean(dim=tuple(range(gates.dim() - 1)))
    ce = _one_hot(topi[..., 0], E, torch.float32).mean(
        dim=tuple(range(topi.dim() - 1)))
    return E * torch.sum(me * ce)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------


def init_embed(g, cfg: ArchConfig) -> Params:
    dt = cfg.tdtype
    p = {"tok": _normal(g, (cfg.padded_vocab, cfg.d_model), 0.02, dt)}
    if cfg.pos == "learned":
        p["pos"] = _normal(g, (8192, cfg.d_model), 0.01, dt)
    return p


def _vocab_lookup(tok: Shards, ids):
    """The vocab-parallel lookup: each model position gives the rows of
    the ids in its vocab range (zeros elsewhere), summed over
    ``model``."""
    vm = tok.parts[0].shape[0]

    def one(m):
        local = ids - m * vm
        inside = ((local >= 0) & (local < vm))[..., None]
        rows = tok.parts[m][torch.clamp(local, 0, vm - 1)]
        return torch.where(inside, rows, torch.zeros((), dtype=rows.dtype,
                                                     device=rows.device))

    return group_psum(per_position(tok.n, one, tok))


def embed(p: Params, tokens, cfg: ArchConfig, positions=None):
    tok = p["tok"]
    ids = tokens.long()
    x = _vocab_lookup(tok, ids) if _split(tok) else tok[ids]
    if cfg.pos == "learned":
        pos = positions if positions is not None else torch.arange(
            tokens.shape[-1], device=tokens.device)
        table = p["pos"]
        if _split(table):          # d_model split: the rows gathered
            idx = torch.clamp(pos, 0, table.parts[0].shape[0] - 1).long()
            pe = group_all_gather(per_position(
                table.n, lambda m: table.parts[m][idx], table), -1)
        else:
            pe = table[torch.clamp(pos, 0, table.shape[0] - 1).long()]
        x = x + pe
    if cfg.family in ("dense", "hybrid") and cfg.name.startswith(
            ("gemma", "recurrentgemma")):
        # √d rounded to x's type first, as jnp.asarray(√d, x.dtype)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(embed_p: Params, head_p: Params | None, x, cfg: ArchConfig):
    """Logits over ``padded_vocab`` columns (the pad region included);
    on a unit's shards each model position's vocab slice, gathered over
    ``model``."""
    parts = unembed_parts(embed_p, head_p, x, cfg)
    if parts is not None:
        return group_all_gather(parts, -1)
    w = embed_p["tok"].T if (cfg.tie_embeddings or head_p is None) \
        else head_p["w"]
    return _mm(x, w)


def unembed_parts(embed_p: Params, head_p: Params | None, x,
                  cfg: ArchConfig) -> list | None:
    """Each model position's logits over its vocab slice, in position
    order, when the head (or the tied embedding) is split over ``model``;
    None otherwise."""
    tied = cfg.tie_embeddings or head_p is None
    w = embed_p["tok"] if tied else head_p["w"]
    if not _split(w):
        return None
    take = _Fan(x, w.n)
    return per_position(w.n, lambda m: linear_part(
        {"w": w.parts[m].T if tied else w.parts[m]}, take), x)


def vocab_parallel_nll(parts: list, labels):
    """The cross-entropy ``logsumexp - the label's logit`` (float32) of
    logits split over the vocab (:func:`unembed_parts`): the ``pmax`` of
    the logits, the ``psum`` of their exponentials and of the label's
    logit over ``model``."""
    vm = parts[0].shape[-1]
    lf = [t.float() for t in parts]
    mx = group_pmax(per_position(len(lf), lambda m: lf[m].amax(-1),
                                 lf[0])).detach()
    se = group_psum(per_position(len(lf), lambda m: torch.exp(
        lf[m] - mx[..., None]).sum(-1), lf[0]))

    def gold(m):
        local = labels - m * vm
        inside = (local >= 0) & (local < vm)
        g = torch.gather(lf[m], -1, torch.clamp(local, 0, vm - 1)[..., None])
        return torch.where(inside, g[..., 0], 0.0)

    return torch.log(se) + mx - group_psum(per_position(len(lf), gold, lf[0]))
