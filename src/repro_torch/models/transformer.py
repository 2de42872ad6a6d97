"""Model assembly for every assigned architecture family.

The port's copy of ``repro/models/transformer.py``.  One entry-point pair
per execution mode:

* ``init_params(cfg, generator)``      — parameter tree; layer stacks are
  *stacked over pattern groups* (a leading ``n_groups`` dim, the
  reference's layout), and the forward loops over the groups.
* ``loss_fn(params, batch, cfg)``      — next-token CE (its value).
* ``prefill(params, batch, cfg)``      — full forward, last-position logits.
* ``decode_step(params, tokens, cache, cfg)`` — one new token against the
  cache/state.  The cache tree mirrors the param group structure.  The
  step writes the cache it is given in place and returns it (the
  reference donates it to ``jax.jit``); it reads nothing on the host, so
  it can be captured into a CUDA graph.

Families: ``dense`` (gemma/qwen/starcoder2/mistral/gpt2), ``moe`` (mixtral,
moonshot), ``ssm`` (mamba2), ``hybrid`` (recurrentgemma rglru:rglru:attn),
``audio`` (whisper enc-dec, frame embeddings stubbed), ``vlm`` (internvl,
patch embeddings stubbed).

``shard_hint`` is the identity: a compute unit's activations are whole
local tensors (``distributed/spmd.py``).  Inside a sharded step the
parameters split over ``model`` reach the blocks as
:class:`~repro_torch.distributed.spmd.Shards` (which leaves:
:func:`tp_split`), and the layer forms of ``layers.py``, ``ssm.py`` and
``rglru.py`` compute each model position's part; ``loss_sums`` takes the
vocab-parallel cross-entropy, and the decode step reads and writes each
position's cache shard where it lies (a block spanning several data
shards of it decodes its cache layers once a shard).  Outside a mesh
every function here is the plain form, unchanged.  ``REPRO_DECODE_WSTAT``
(read at import) is the reference's weight-stationary decode: the sharded
serve step leaves the dense weights where they lie over ``data``, each
position contracts its FSDP shard of the hidden's model dim, and the
partial sums are summed over ``data`` (``layers._mm``).

``remat`` is activation checkpointing where the reference wraps
``jax.checkpoint``: each pattern group of the backbone, each decoder layer
of an encoder-decoder, each encoder layer, and (always) each loss chunk
run under ``torch.utils.checkpoint.checkpoint`` (non-reentrant, the RNG
state not preserved: the forward draws no random numbers, and reading the
CUDA RNG state would break a graph capture), so the backward recomputes
them.  ``REPRO_REMAT_POLICY=dots`` saves the 2-D matmul outputs across
the boundary, as the reference's ``dots_with_no_batch_dims_saveable``.
The backbone reads each group's parameters as ``unbind`` views of the
stacked tree, whose backward stacks the groups' gradients once.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import BATCH, shard_hint
from . import rglru as rg
from . import ssm as ssm_mod
from .layers import (Params, _device, apply_norm, attention_decode,
                     attention_train, cross_attention, dense_init, embed,
                     encode_kv, ffn_apply, init_attention, init_embed,
                     init_ffn, init_moe, moe_apply, norm_init, tree_leaves,
                     tree_map, unembed, unembed_parts, vocab_parallel_nll)

# REPRO_DECODE_WSTAT=1  the weight-stationary decode (read at import, as
# the reference reads it at trace time; see the module docstring).
_DECODE_WSTAT = os.environ.get("REPRO_DECODE_WSTAT", "0") == "1"

# --------------------------------------------------------------------------
# Per-block init/apply
# --------------------------------------------------------------------------


def _init_block(g, cfg: ArchConfig, kind: str) -> Params:
    dt = cfg.tdtype
    dev = _device(g)
    if kind == "attn":
        p = {"norm1": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
             "attn": init_attention(g, cfg),
             "norm2": norm_init(cfg.d_model, cfg.norm, dt, device=dev)}
        p["mlp"] = init_moe(g, cfg) if cfg.moe else init_ffn(g, cfg)
        return p
    if kind == "rglru":
        return {"rec": rg.init_rglru_block(g, cfg),
                "norm2": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
                "mlp": init_ffn(g, cfg)}
    if kind == "ssm":
        return {"ssm": ssm_mod.init_ssm_block(g, cfg)}
    if kind == "xattn":  # whisper decoder block
        return {"norm1": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
                "attn": init_attention(g, cfg),
                "norm_x": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
                "xattn": init_attention(g, cfg),
                "norm2": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
                "mlp": init_ffn(g, cfg)}
    raise ValueError(kind)


def _mlp(p: Params, x, cfg: ArchConfig):
    if cfg.moe:
        return moe_apply(p, x, cfg)
    return ffn_apply(p, x, cfg)


def _attn_window(cfg: ArchConfig, kind: str) -> int:
    if kind not in ("attn",):
        return 0
    if len(cfg.block_pattern) > 1:          # hybrid local-attn blocks
        return cfg.local_window
    return cfg.window


def _block_train(p: Params, x, cfg: ArchConfig, kind: str, *, enc_out=None):
    if kind == "attn":
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + attention_train(p["attn"], h, cfg, causal=True,
                                window=_attn_window(cfg, kind))
        h = apply_norm(p["norm2"], x, cfg.norm)
        return x + _mlp(p["mlp"], h, cfg)
    if kind == "rglru":
        x = rg.rglru_block_train(p["rec"], x, cfg)
        h = apply_norm(p["norm2"], x, cfg.norm)
        return x + ffn_apply(p["mlp"], h, cfg)
    if kind == "ssm":
        return ssm_mod.ssm_block_train(p["ssm"], x, cfg)
    if kind == "xattn":
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + attention_train(p["attn"], h, cfg, causal=True)
        h = apply_norm(p["norm_x"], x, cfg.norm)
        ekv = encode_kv(p["xattn"], enc_out, cfg)
        x = x + cross_attention(p["xattn"], h, ekv, cfg)
        h = apply_norm(p["norm2"], x, cfg.norm)
        return x + ffn_apply(p["mlp"], h, cfg)
    raise ValueError(kind)


def tp_split(cfg: ArchConfig, n: int):
    """Which parameter leaves (by path, ``groups/b0_attn/attn/wq/w``) the
    tensor-parallel forms read split over ``n`` model positions: the
    reference's ``param_specs`` split the others too, but their forms read
    them whole (Mamba-2's ``in_proj`` / ``conv``, packed z|x|B|C|dt; K/V
    where the KV heads do not divide; a layer whose heads do not divide)."""
    def split(path: str) -> bool:
        if n < 2:
            return False
        keys = path.split("/")
        if "attn" in keys or "xattn" in keys:
            if cfg.n_heads % n:
                return False
            return keys[-2] not in ("wk", "wv") or cfg.n_kv_heads % n == 0
        if "ssm" in keys:
            s = cfg.ssm
            heads = cfg.d_model * s.expand // s.head_dim
            return path.endswith("out_proj/w") and heads % n == 0
        return "rec" in keys or "mlp" in keys or keys[0] in ("embed",
                                                              "lm_head")
    return split


# --------------------------------------------------------------------------
# Parameter assembly (stacked pattern groups)
# --------------------------------------------------------------------------


def _group_counts(cfg: ArchConfig) -> tuple[int, int]:
    plen = len(cfg.block_pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def _stack(trees: list) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda t: t[i], stacked)


def init_params(cfg: ArchConfig, generator=None, *, device=None) -> Params:
    """The parameter tree, drawn in order from ``generator`` (a
    ``torch.Generator``, in place of the reference's PRNG key) on its
    device, then moved to ``device``: the card when it is None, the CPU
    only when asked for.  The reference and the port draw different
    numbers from one seed: a tree made by the reference crosses with
    :func:`repro_torch.models.params_from_numpy`."""
    from ..api import resolve_device
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), _draw_params(cfg, generator))


def _draw_params(cfg: ArchConfig, g) -> Params:
    """The parameter tree drawn from ``g`` on its device (under a
    ``torch.device`` context, on that device when ``g`` is None)."""
    dt = cfg.tdtype
    dev = _device(g)
    n_groups, leftover = _group_counts(cfg)

    def group_params():
        return {f"b{i}_{kind}": _init_block(g, cfg, kind)
                for i, kind in enumerate(cfg.block_pattern)}

    p: Params = {
        "embed": init_embed(g, cfg),
        "tail": {f"t{i}": _init_block(g, cfg, cfg.block_pattern[i])
                 for i in range(leftover)},
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
    }
    if cfg.enc_dec:
        p["encoder"] = _stack([
            {"norm1": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
             "attn": init_attention(g, cfg),
             "norm2": norm_init(cfg.d_model, cfg.norm, dt, device=dev),
             "mlp": init_ffn(g, cfg)}
            for _ in range(cfg.n_enc_layers)])
        p["enc_norm"] = norm_init(cfg.d_model, cfg.norm, dt, device=dev)
        p["decoder"] = _stack([_init_block(g, cfg, "xattn")
                               for _ in range(cfg.n_layers)])
        p["groups"] = {}
    else:
        p["groups"] = _stack([group_params() for _ in range(n_groups)]) \
            if n_groups else {}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(g, cfg.d_model, cfg.padded_vocab, dt)
    return p


def param_shapes(cfg: ArchConfig) -> Any:
    """Shape/dtype tree without allocation (meta tensors)."""
    with torch.device("meta"):
        return _draw_params(cfg, None)


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


# --------------------------------------------------------------------------
# Forward (training / prefill-scoring)
# --------------------------------------------------------------------------


# REPRO_REMAT_POLICY=dots  save matmul outputs across the remat boundary
# (read at import, as the reference reads it at trace time).
_REMAT_POLICY = os.environ.get("REPRO_REMAT_POLICY", "")


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective checkpoint policy of ``REPRO_REMAT_POLICY=dots``:
    products with no batch dimension (``aten.mm``, which ``x @ w`` of an
    activation and a weight lowers to) are saved, the rest recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, *args, policy: bool = True):
    """``fn(*args)`` under activation checkpointing (the reference's
    ``jax.checkpoint``; its ``_checkpoint`` with ``policy``, which reads
    ``REPRO_REMAT_POLICY``)."""
    from torch.utils.checkpoint import checkpoint

    from ..distributed.spmd import recomputed
    kw = {}
    if policy and _REMAT_POLICY == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return checkpoint(recomputed(fn), *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _diffable_barrier(x):
    """The identity.  The reference's is an XLA optimization barrier (with
    an identity VJP) that stops XLA hoisting the norm's float32 convert
    out of the layer loop; eager torch hoists nothing, so there is no
    counterpart to write."""
    return x


def _layers(stacked: Params, n: int) -> list:
    """The ``n`` layers of a stacked tree as ``unbind`` views: one
    ``UnbindBackward`` stacks their gradients (a ``select`` a layer would
    write a zeroed full-size gradient for each)."""
    parts = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


def _encode(params: Params, frames, cfg: ArchConfig, remat: bool):
    def body(h, lp):
        hh = apply_norm(lp["norm1"], h, cfg.norm)
        h = h + attention_train(lp["attn"], hh, cfg, causal=False)
        hh = apply_norm(lp["norm2"], h, cfg.norm)
        return h + ffn_apply(lp["mlp"], hh, cfg)

    h = frames
    for lp in _layers(params["encoder"], cfg.n_enc_layers):
        h = (_checkpoint(functools.partial(body, lp=lp), h, policy=False)
             if remat else body(h, lp))
    return apply_norm(params["enc_norm"], h, cfg.norm)


def _backbone(params: Params, x, cfg: ArchConfig, *, remat: bool,
              enc_out=None):
    if cfg.enc_dec:
        def dec_body(h, lp):
            h = shard_hint(h, BATCH, "model", None)
            return shard_hint(_block_train(lp, h, cfg, "xattn",
                                           enc_out=enc_out),
                              BATCH, "model", None)

        for lp in _layers(params["decoder"], cfg.n_layers):
            x = (_checkpoint(functools.partial(dec_body, lp=lp), x)
                 if remat else dec_body(x, lp))
        return x

    def group_body(h, gp):
        h = _diffable_barrier(h)
        h = shard_hint(h, BATCH, "model", None)
        for i, kind in enumerate(cfg.block_pattern):
            h = _block_train(gp[f"b{i}_{kind}"], h, cfg, kind)
        return shard_hint(h, BATCH, "model", None)

    n_groups, leftover = _group_counts(cfg)
    if n_groups:
        for gp in _layers(params["groups"], n_groups):
            x = (_checkpoint(functools.partial(group_body, gp=gp), x)
                 if remat else group_body(x, gp))
    for i in range(leftover):
        x = _block_train(params["tail"][f"t{i}"], x, cfg, cfg.block_pattern[i])
    return x


def forward_hidden(params: Params, batch: dict, cfg: ArchConfig,
                   remat: bool = True):
    """batch -> final-norm hidden states (B, S_text, d_model)."""
    x = shard_hint(embed(params["embed"], batch["tokens"], cfg), BATCH, None,
                   None)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encode(params, batch["frames"], cfg, remat)
    if cfg.n_patches:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = _backbone(params, x, cfg, remat=remat, enc_out=enc_out)
    if cfg.n_patches:
        x = x[:, cfg.n_patches:]
    return apply_norm(params["final_norm"], x, cfg.norm)


def forward(params: Params, batch: dict, cfg: ArchConfig,
            remat: bool = True):
    """batch -> logits (B, S_text, padded_vocab)."""
    x = forward_hidden(params, batch, cfg, remat)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg)
    return shard_hint(logits, BATCH, None, "model")


def _loss_chunk(s: int, target: int = 2048) -> int:
    """Largest divisor of ``s`` not exceeding ``target``."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def loss_sums(params: Params, batch: dict, cfg: ArchConfig,
              remat: bool = True, loss_chunk: int = 2048):
    """``(Σ nll·mask, Σ mask)`` of the next-token CE, float32 0-d tensors:
    :func:`loss_fn` before its division, which a sharded step reduces
    across the data-parallel positions before it divides."""
    x = forward_hidden(params, batch, cfg, remat=remat)
    labels = batch["labels"]
    B, S, D = x.shape
    c = _loss_chunk(S, loss_chunk)

    def chunk_nll(xc, lc):
        parts = unembed_parts(params["embed"], params.get("lm_head"), xc, cfg)
        if parts is not None:          # the head's vocab split over `model`
            mask = (lc >= 0).float()
            nll = vocab_parallel_nll(parts, torch.clamp(lc, min=0).long())
            return (nll * mask).sum(), mask.sum()
        logits = unembed(params["embed"], params.get("lm_head"), xc, cfg)
        logits = shard_hint(logits, BATCH, None, "model").float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[
            ..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(S // c):
        xc, lc = x[:, ci * c:(ci + 1) * c], labels[:, ci * c:(ci + 1) * c]
        t, n = _checkpoint(chunk_nll, xc, lc, policy=False)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


def loss_fn(params: Params, batch: dict, cfg: ArchConfig,
            remat: bool = True, loss_chunk: int = 2048):
    """Next-token CE with **sequence-chunked** logits: the (B, S, vocab)
    float32 logit tensor never materializes — each chunk computes its
    unembed matmul, reduces to per-token NLL, summed in chunk order, and
    is recomputed in the backward (checkpointed, as in the reference)."""
    tot, cnt = loss_sums(params, batch, cfg, remat, loss_chunk)
    return tot / torch.clamp(cnt, min=1.0)


def prefill(params: Params, batch: dict, cfg: ArchConfig):
    """Prefill scoring: full forward, last-position logits."""
    return forward(params, batch, cfg, remat=False)[:, -1]


# --------------------------------------------------------------------------
# Decode (serve_step)
# --------------------------------------------------------------------------


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """Ring-buffer length: windowed archs cap the KV cache at the window."""
    if len(cfg.block_pattern) > 1 and "attn" in cfg.block_pattern:
        return min(seq_len, cfg.local_window)
    if cfg.window:
        return min(seq_len, cfg.window)
    return seq_len


def _init_block_cache(cfg: ArchConfig, batch: int, C: int, kind: str,
                      device=None) -> Params:
    dt = cfg.tdtype

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("attn", "xattn"):
        shape = (batch, C, cfg.n_kv_heads, cfg.hd)
        return {"k": zeros(shape, dt), "v": zeros(shape, dt)}
    if kind == "rglru":
        return {"h": zeros((batch, cfg.d_model), torch.float32),
                "conv": zeros((batch, 3, cfg.d_model), dt)}
    if kind == "ssm":
        s = cfg.ssm
        d_in = cfg.d_model * s.expand
        nheads = d_in // s.head_dim
        return {"state": zeros((batch, nheads, s.head_dim, s.d_state),
                               torch.float32),
                "conv": zeros((batch, s.conv_width - 1,
                               d_in + 2 * s.d_state), dt)}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               device=None) -> Params:
    """The decode cache on ``device`` (the card when it is None, the CPU
    only when asked for).  The encoder-decoder cache's ``k`` and ``v`` are
    two tensors (the reference aliases them, harmless only where nothing
    is written in place)."""
    from ..api import resolve_device
    device = resolve_device(device)
    n_groups, leftover = _group_counts(cfg)
    C = cache_len_for(cfg, seq_len)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32,
                                        device=device)}
    if cfg.enc_dec:
        shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.hd)
        cache["layers"] = {
            "k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}
        cache["enc_out"] = torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                       dtype=cfg.tdtype, device=device)
        return cache
    if n_groups:
        cache["groups"] = {
            f"b{i}_{kind}": tree_map(
                lambda x: torch.zeros((n_groups,) + tuple(x.shape),
                                      dtype=x.dtype, device=device),
                _init_block_cache(cfg, batch, C, kind, device="meta"))
            for i, kind in enumerate(cfg.block_pattern)}
    cache["tail"] = {f"t{i}": _init_block_cache(cfg, batch, C,
                                                cfg.block_pattern[i], device)
                     for i in range(leftover)}
    return cache


def _by_rows(bc: Params, x, fn):
    """``fn(x, bc)``; where the block's cache spans several data shards
    (:class:`~repro_torch.distributed.spmd.Rows`), once a shard on its
    rows of ``x``, the outputs concatenated."""
    from ..distributed.spmd import Rows
    first = tree_leaves(bc)[0]
    if not isinstance(first, Rows):
        return fn(x, bc)
    outs = []
    for j, (lo, hi, _) in enumerate(first.blocks):
        outs.append(fn(x[lo:hi], tree_map(lambda r: r.blocks[j][2], bc)))
    return torch.cat(outs)


def _into(dst, src) -> None:
    """Write a decode state into its cache leaf (the tensor-parallel forms
    wrote theirs in place)."""
    if src is not dst:
        dst.copy_(src)


def _block_decode(p: Params, x, cfg: ArchConfig, kind: str, bc: Params,
                  pos, enc_out=None):
    """Returns (x, the block cache ``bc`` written in place)."""
    if kind in ("attn", "xattn"):
        window = _attn_window(cfg, kind)
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + _by_rows(bc, h, lambda hh, c: attention_decode(
            p["attn"], hh, cfg, k_cache=c["k"], v_cache=c["v"], pos=pos,
            window=window)[0])
        if kind == "xattn":
            h = apply_norm(p["norm_x"], x, cfg.norm)
            ekv = encode_kv(p["xattn"], enc_out, cfg)
            x = x + cross_attention(p["xattn"], h, ekv, cfg)
            h = apply_norm(p["norm2"], x, cfg.norm)
            return x + ffn_apply(p["mlp"], h, cfg), bc
        h = apply_norm(p["norm2"], x, cfg.norm)
        return x + _mlp(p["mlp"], h, cfg), bc
    if kind == "rglru":
        def rec(xx, c):
            y, hs, cb = rg.rglru_block_decode(p["rec"], xx, cfg,
                                              h_state=c["h"],
                                              conv_buf=c["conv"])
            _into(c["h"], hs)
            _into(c["conv"], cb)
            return y

        x = _by_rows(bc, x, rec)
        h = apply_norm(p["norm2"], x, cfg.norm)
        return x + ffn_apply(p["mlp"], h, cfg), bc
    if kind == "ssm":
        def mix(xx, c):
            y, st, cb = ssm_mod.ssm_block_decode(p["ssm"], xx, cfg,
                                                 state=c["state"],
                                                 conv_buf=c["conv"])
            _into(c["state"], st)
            _into(c["conv"], cb)
            return y

        return _by_rows(bc, x, mix), bc
    raise ValueError(kind)


def decode_step(params: Params, tokens, cache: Params, cfg: ArchConfig):
    """tokens: (B,) int32.  Returns (logits (B, vocab), cache): ``cache``
    itself, every leaf written in place and ``pos`` one further."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens[:, None], cfg,
              positions=pos[None, None] if cfg.pos == "learned" else None)

    if cfg.enc_dec:
        enc_out = cache["enc_out"]
        for i in range(cfg.n_layers):
            x, _ = _block_decode(_layer(params["decoder"], i), x, cfg,
                                 "xattn", _layer(cache["layers"], i), pos,
                                 enc_out)
    else:
        n_groups, leftover = _group_counts(cfg)
        for gi in range(n_groups):
            gp, gc = _layer(params["groups"], gi), _layer(cache["groups"], gi)
            for i, kind in enumerate(cfg.block_pattern):
                key = f"b{i}_{kind}"
                x, _ = _block_decode(gp[key], x, cfg, kind, gc[key], pos)
        for i in range(leftover):
            kind = cfg.block_pattern[i]
            x, _ = _block_decode(params["tail"][f"t{i}"], x, cfg, kind,
                                 cache["tail"][f"t{i}"], pos)

    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(params["embed"], params.get("lm_head"), x[:, 0], cfg)
    pos.add_(1)                     # after every read of this step's pos
    return shard_hint(logits, BATCH, "model"), cache


# --------------------------------------------------------------------------
# CODO traced form: one attention head over batched (BH, S, hd) operands,
# expressed in the dataflow-frontend vocabulary so ``codo_torch.compile``
# sees the matmul -> scale -> softmax -> matmul chain the ``flashattn.mha``
# pattern routes.
# --------------------------------------------------------------------------


def mha_batched_fn(q, k, v):
    """Batched single-head attention ``softmax(q kᵀ / √hd) v``; operands
    are ``(BH, S, hd)`` (heads folded into the leading batch dim)."""
    from ..core import frontend as F
    hd = q.shape[-1]
    kt = F.transpose(k)                       # (BH, hd, S)
    s = F.scale(F.matmul(q, kt), 1.0 / math.sqrt(hd))
    p = F.softmax(s)
    return F.matmul(p, v)
