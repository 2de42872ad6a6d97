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
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig

Params = dict

# --- §Perf hillclimb switches (read at import, as the reference reads them
# at trace time).  See repro/models/layers.py for what each one trades.
# A position's activations are whole local tensors of its own program (the
# sharded steps split the batch and gather the weights around the model,
# and shard_hint is the identity), so the reference's sequence-parallel
# form runs with P = 1 and is the same loop over q blocks as the plain form:
# REPRO_ATTN_SEQSHARD selects nothing here, and REPRO_ATTN_OPT only repeats
# the KV heads.  Their mesh forms come with tensor-parallel compute over
# `model` (ROADMAP.md, Queue 1 item 11).
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


def linear(p: Params, x):
    y = dot_bf16bwd(x, p["w"]) if _BF16_BWD else x @ p["w"]
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


def attention_train(p: Params, x, cfg: ArchConfig, *, causal: bool = True,
                    window: int = 0, positions=None):
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.pos == "rope":
        pos = positions if positions is not None else torch.arange(
            S, device=x.device)[None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if S > 2048:
        o = blockwise_attention(q, k, v, causal=causal, window=window)
    else:
        o = full_attention(q, k, v, causal=causal, window=window)
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
    B = x.shape[0]
    C = k_cache.shape[1]
    q, k, v = _qkv(p, x, cfg)
    if cfg.pos == "rope":
        q = apply_rope(q, pos[None, None], cfg.rope_theta)
        k = apply_rope(k, pos[None, None], cfg.rope_theta)
    slot = pos % max(C, 1) if window > 0 else pos
    slot = torch.clamp(slot, 0, C - 1).reshape(1).long()
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    # positions held in each cache slot (ring-aware)
    slots = torch.arange(C, device=x.device)
    if window > 0:
        # absolute position stored in slot s: the largest p <= pos with
        # p % C == s
        kpos = pos - torch.remainder(pos - slots, C)
        valid = kpos >= torch.clamp(pos - window + 1, min=0)
        kpos = torch.where(valid, kpos, -1)
    else:
        kpos = torch.where(slots <= pos, slots, -1)
    qg = q.reshape(B, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k_cache.float()) / math.sqrt(cfg.hd)
    s = torch.where((kpos >= 0)[None, None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v_cache.float())
    o = o.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return linear(p["wo"], o), k_cache, v_cache


def init_cross_attention(g, cfg: ArchConfig) -> Params:
    return init_attention(g, cfg)


def cross_attention(p: Params, x, enc_kv, cfg: ArchConfig):
    """Decoder->encoder attention; enc_kv precomputed (B, F, Hkv, hd)."""
    B, S, _ = x.shape
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.hd)
    k, v = enc_kv
    o = full_attention(q, k, v, causal=False)
    return linear(p["wo"], o.reshape(B, S, cfg.q_dim))


def encode_kv(p: Params, enc_out, cfg: ArchConfig):
    B, Fr, _ = enc_out.shape
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


def ffn_apply(p: Params, x, cfg: ArchConfig):
    h = linear(p["w_in"], x)
    if cfg.glu:
        h = activation(linear(p["w_gate"], x), cfg.act) * h
    else:
        h = activation(h, cfg.act)
    return linear(p["w_out"], h)


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
        h = torch.einsum("epd,edf->epf", xe, p["w_in"])
        if cfg.glu:
            gt = torch.einsum("epd,edf->epf", xe, p["w_gate"])
            h = activation(gt, cfg.act) * h
        else:
            h = activation(h, cfg.act)
        ye = torch.einsum("epf,efd->epd", h, p["w_out"])
        comb = torch.einsum("cke,ckp,ck->cep", sel,
                            _one_hot(pos, C, torch.float32), wc.float())
        yc = torch.einsum("cep,epd->cd", comb, ye.float())
        ys.append(yc.to(xc.dtype))
    return torch.cat(ys).reshape(B, S, D)


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


def embed(p: Params, tokens, cfg: ArchConfig, positions=None):
    x = p["tok"][tokens.long()]
    if cfg.pos == "learned":
        pos = positions if positions is not None else torch.arange(
            tokens.shape[-1], device=tokens.device)
        pe = p["pos"][torch.clamp(pos, 0, p["pos"].shape[0] - 1).long()]
        x = x + pe
    if cfg.family in ("dense", "hybrid") and cfg.name.startswith(
            ("gemma", "recurrentgemma")):
        # √d rounded to x's type first, as jnp.asarray(√d, x.dtype)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(embed_p: Params, head_p: Params | None, x, cfg: ArchConfig):
    """Logits over ``padded_vocab`` columns (the pad region included)."""
    w = embed_p["tok"].T if (cfg.tie_embeddings or head_p is None) \
        else head_p["w"]
    return dot_bf16bwd(x, w) if _BF16_BWD else x @ w
