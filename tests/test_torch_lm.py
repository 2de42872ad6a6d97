"""The LM stack of the port (``repro_torch.models``) against the JAX
reference, on the CPU.

The reference draws every parameter tree (``init_params`` with a PRNG
key) and every batch (``make_batch``'s numpy draws); the tree crosses
into the port through ``params_from_numpy``, the batch is drawn again by
the port and must agree bit for bit.  For every catalog architecture at
its ``smoke()`` config (float32):

* ``forward`` and ``prefill`` within 1e-5 of the output's scale, and
  ``loss_fn``'s value within rtol 1e-5;
* three ``decode_step``s: the logits within 1e-5 of their scale, every
  cache leaf within 1e-5 of its own scale, ``pos`` exactly.

Then the places where the port had to think again: ``blockwise_attention``
at small blocks (causal, windowed, offset), the MoE dispatch (exact, with
its capacity dropping tokens), the decode cache's clamp at ``pos >= C``,
the windowed ring, each forward ``REPRO_*`` switch (module globals
patched in both packages), the LM's ``rglru`` / ``ssd`` kernel calls
against the reference's jnp scans, parameter and cache shapes at full
width (meta tensors against ``jax.eval_shape``), and ``bfloat16`` trees
crossing exactly.  Measured: every band holds with room (forward ≤
1.4e-6 of scale, decode ≤ 9.3e-7, loss ≤ 3.0e-7 relative).  The CUDA
kernels run only on the card (``chip_smoke.py``'s LM phase).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import CONFIGS as REF_CONFIGS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import CONFIGS, get_config  # noqa: E402
from repro_torch.models import layers, rglru, ssm  # noqa: E402

ARCHS = sorted(REF_CONFIGS)
SCALE_BAND = 1e-5            # of the output's scale
LOSS_RTOL = 1e-5


def _flat(tree, pre=""):
    """{path: numpy array} of a nest of dicts of jax arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {pre: tree.detach().float().numpy()
                if tree.dtype == torch.bfloat16 else tree.detach().numpy()}
    return {pre: np.asarray(tree)}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, band=SCALE_BAND):
    rel = _rel(got, want)
    assert rel <= band, f"{rel:.3e} of scale > {band:.0e}"
    return rel


@pytest.fixture(scope="module")
def smoke_pair():
    """(reference cfg, port cfg, reference params, port params) of an
    arch at ``smoke()``, drawn once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
            rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
            cache[arch] = (rcfg, cfg, rp,
                           M.params_from_numpy(jax.device_get(rp),
                                               device="cpu"))
        return cache[arch]

    return get


def test_catalogs_agree():
    assert sorted(CONFIGS) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_loss_match_reference(smoke_pair, arch):
    rcfg, cfg, rp, tp = smoke_pair(arch)
    rb = RM.make_batch(rcfg, batch=2, seq=64, kind="train", seed=1)
    tb = M.make_batch(cfg, batch=2, seq=64, kind="train", seed=1,
                      device="cpu")
    assert rb.keys() == tb.keys()
    for k in rb:
        assert np.array_equal(np.asarray(rb[k]), tb[k].numpy()), k
    want = np.asarray(RM.forward(rp, rb, rcfg, remat=False))
    got = M.forward(tp, tb, cfg)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(M.prefill(tp, tb, cfg).numpy(), want[:, -1])
    loss = float(M.loss_fn(tp, tb, cfg))
    assert loss == pytest.approx(float(RM.loss_fn(rp, rb, rcfg, remat=False)),
                                 rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(smoke_pair, arch):
    rcfg, cfg, rp, tp = smoke_pair(arch)
    rc = RM.init_cache(rcfg, batch=2, seq_len=64)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    toks = np.array([1, 7], np.int32)
    for _ in range(3):
        rl, rc = RM.decode_step(rp, jnp.asarray(toks), rc, rcfg)
        tl, tc2 = M.decode_step(tp, torch.from_numpy(toks), tc, cfg)
        assert tc2 is tc                          # written in place
        _close(tl.numpy(), np.asarray(rl))
        toks = (np.asarray(rl).argmax(-1) % rcfg.vocab).astype(np.int32)
    want, got = _flat(jax.device_get(rc)), _flat(tc)
    assert want.keys() == got.keys()
    assert int(got["/pos"]) == int(want["/pos"]) == 3
    for path in want:
        if np.abs(want[path]).max() > 0:
            _close(got[path], want[path])
        else:
            assert not np.abs(got[path]).any(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_at_full_width_is_the_references(arch):
    """The published dtype (bfloat16 frames and patch embeddings) too."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    seq = cfg.n_patches + 8
    for kind in ("train", "prefill", "decode"):
        rb = RM.make_batch(rcfg, batch=1, seq=seq, kind=kind, seed=3)
        tb = M.make_batch(cfg, batch=1, seq=seq, kind=kind, seed=3,
                          device="cpu")
        assert rb.keys() == tb.keys()
        for k in rb:
            got = tb[k].float().numpy() if tb[k].is_floating_point() \
                else tb[k].numpy()
            assert np.array_equal(np.asarray(rb[k], got.dtype), got), k


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_at_full_width_are_the_references(arch):
    """``param_shapes`` (meta tensors) and ``init_cache`` against the
    reference's ``jax.eval_shape``, path by path, and ``batch_spec``."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro_torch.configs import SHAPES
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}

    def same(ours, theirs):
        ours, theirs = _meta(ours), _meta(theirs)
        assert ours.keys() == theirs.keys()
        for path, (shape, dt) in theirs.items():
            assert ours[path] == (shape, tdt[dt]), path

    ours, theirs = M.param_shapes(cfg), RM.param_shapes(rcfg)
    same(ours, theirs)
    assert M.param_count(ours) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(theirs))
    cache = M.init_cache(cfg, 2, 4096, device="meta")
    same(cache, jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 4096)))
    if cfg.enc_dec:
        assert cache["layers"]["k"] is not cache["layers"]["v"]
    for name in SHAPES:
        same(M.batch_spec(cfg, SHAPES[name]),
             RM.batch_spec(rcfg, REF_SHAPES[name]))


def _meta(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_meta(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {pre: (tuple(tree.shape), tree.dtype)}
    return {pre: (tuple(tree.shape), np.dtype(tree.dtype).name)}


def test_params_from_numpy_carries_bfloat16_exactly():
    rcfg = dataclasses.replace(ref_get_config("gpt2-medium").smoke(),
                               dtype="bfloat16")
    rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(2)))
    tp = M.params_from_numpy(rp, device="cpu")
    want, got = _flat(rp), _flat(tp)
    for path, w in want.items():
        assert got[path].dtype == np.float32 or w.dtype.name != "bfloat16"
        assert np.array_equal(np.asarray(w, np.float32), got[path]), path
    assert M.layers.tree_leaves(tp)[0].dtype == torch.bfloat16
    as32 = M.params_from_numpy(rp, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32
               for t in M.layers.tree_leaves(as32))


# --------------------------------------------------------------------------
# Attention: blockwise, clamp, ring
# --------------------------------------------------------------------------


def _qkv(rng, B, S, Hq, Hkv, hd):
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 24, 0), (False, 0, 0), (True, 16, 32)])
def test_blockwise_attention_matches_reference(causal, window, q_offset):
    q, k, v = _qkv(np.random.default_rng(4), 2, 64, 4, 2, 8)
    if q_offset:
        k = np.concatenate([k, k[:, :32]], axis=1)
        v = np.concatenate([v, v[:, :32]], axis=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=16,
              block_k=32)
    want = np.asarray(ref_layers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got.numpy(), want)
    if not q_offset:            # and the unblocked form, as the reference's
        full = layers.full_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window)
        _close(got.numpy(), full.numpy())


def _decode_both(rcfg, cfg, seq_len, steps, seed=5):
    """``steps`` teacher-forced decode steps of both packages at
    ``cache_len_for(seq_len)``; returns the logits and the caches."""
    rp = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    rc = RM.init_cache(rcfg, 2, seq_len)
    tc = M.init_cache(cfg, 2, seq_len, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (steps, 2))
    rls, tls = [], []
    for t in range(steps):
        tok = toks[t].astype(np.int32)
        rl, rc = RM.decode_step(rp, jnp.asarray(tok), rc, rcfg)
        tl, tc = M.decode_step(tp, torch.from_numpy(tok), tc, cfg)
        rls.append(np.asarray(rl))
        tls.append(tl.numpy())
    return np.stack(rls), np.stack(tls), _flat(jax.device_get(rc)), _flat(tc)


def test_decode_cache_clamps_at_its_last_slot():
    """Past its length a plain cache writes its last slot again, as
    ``lax.dynamic_update_slice`` clamps its start: no raise, no wrap."""
    rcfg, cfg = (c("gpt2-medium").smoke() for c in (ref_get_config,
                                                    get_config))
    C, steps = 4, 7
    assert M.cache_len_for(cfg, C) == C
    rl, tl, rc, tc = _decode_both(rcfg, cfg, C, steps)
    _close(tl, rl)
    assert int(tc["/pos"]) == steps
    for path in rc:
        if path != "/pos":
            _close(tc[path], rc[path])
    # slots 0..C-2 hold steps 0..C-2; the last slot the last step's key
    k = tc["/groups/b0_attn/k"]
    rl2, tl2, _, tc2 = _decode_both(rcfg, cfg, C, C - 1)
    np.testing.assert_array_equal(k[:, :, :C - 1], tc2["/groups/b0_attn/k"][
        :, :, :C - 1])
    assert not np.array_equal(k[:, :, C - 1], tc2["/groups/b0_attn/k"][
        :, :, C - 1])


@pytest.mark.parametrize("window,seq_len,steps", [(64, 8, 13), (4, 16, 11)])
def test_windowed_ring_matches_reference(window, seq_len, steps):
    """starcoder2's sliding window: a ring of C = min(seq, window) slots
    wrapping past C, and a window shorter than the positions held."""
    rcfg, cfg = (dataclasses.replace(c("starcoder2-15b").smoke(),
                                     window=window)
                 for c in (ref_get_config, get_config))
    assert M.cache_len_for(cfg, seq_len) == min(seq_len, window)
    rl, tl, rc, tc = _decode_both(rcfg, cfg, seq_len, steps)
    _close(tl, rl)
    for path in rc:
        if path != "/pos":
            _close(tc[path], rc[path])
    assert int(tc["/pos"]) == steps


# --------------------------------------------------------------------------
# MoE dispatch
# --------------------------------------------------------------------------


def _ref_dispatch(topi, E, C):
    """The reference's capacity bookkeeping (``moe_apply``'s one_chunk),
    on its own top-k indices."""
    c, K = topi.shape
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    flat = onehot.reshape(-1, E)
    pos_in_e = (jnp.cumsum(flat, axis=0) - flat).reshape(c, K, E)
    pos = jnp.einsum("cke,cke->ck", pos_in_e, onehot).astype(jnp.int32)
    return np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_moe_dispatch_is_exact_and_drops_tokens(smoke_pair, arch):
    rcfg, cfg, rp, tp = smoke_pair(arch)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=0.75))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.75))
    mlp_r, mlp_t = rp["groups"]["b0_attn"]["mlp"], tp["groups"]["b0_attn"][
        "mlp"]
    mlp_r = jax.tree.map(lambda a: a[0], mlp_r)
    mlp_t = layers.tree_map(lambda t: t[0], mlp_t)
    x = np.random.default_rng(6).standard_normal((2, 32, 64)).astype(
        np.float32)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    C = max(1, int(64 * K * cfg.moe.capacity_factor / E))
    xt = x.reshape(-1, 64)
    gates = jax.nn.softmax((jnp.asarray(xt) @ mlp_r["router"]["w"]).astype(
        jnp.float32), axis=-1)
    _, ref_topi = jax.lax.top_k(gates, K)
    logits = torch.from_numpy(xt) @ mlp_t["router"]["w"]
    _, topi = torch.topk(torch.softmax(logits.float(), -1), K)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ref_topi))
    _, pos, keep = layers.moe_dispatch(topi, E, C)
    ref_pos, ref_keep = _ref_dispatch(ref_topi, E, C)
    np.testing.assert_array_equal(pos.numpy(), ref_pos)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert not keep.all() and keep.any()          # the capacity drops some
    want = np.asarray(ref_layers.moe_apply(mlp_r, jnp.asarray(x), rcfg))
    got = layers.moe_apply(mlp_t, torch.from_numpy(x), cfg)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# The REPRO_* forward switches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("switch,value", [
    ("_ATTN_OPT", True), ("_ATTN_SEQSHARD", True),
    ("_MOE_BF16", True), ("_MOE_CHUNK", 16)])
def test_forward_switches_match_reference(smoke_pair, monkeypatch, switch,
                                          value):
    for mod in (ref_layers, layers):
        monkeypatch.setattr(mod, switch, value)
    if switch.startswith("_ATTN"):
        q, k, v = _qkv(np.random.default_rng(7), 2, 64, 4, 2, 8)
        kw = dict(causal=True, window=24, block_q=16, block_k=32)
        want = np.asarray(ref_layers.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                         **kw)
        _close(got.numpy(), want)
        return
    rcfg, cfg, rp, tp = smoke_pair("mixtral-8x22b")
    x = np.random.default_rng(8).standard_normal((2, 32, 64)).astype(
        np.float32)
    mlp_r = jax.tree.map(lambda a: a[0], rp["groups"]["b0_attn"]["mlp"])
    mlp_t = layers.tree_map(lambda t: t[0], tp["groups"]["b0_attn"]["mlp"])
    want = np.asarray(ref_layers.moe_apply(mlp_r, jnp.asarray(x), rcfg))
    got = layers.moe_apply(mlp_t, torch.from_numpy(x), cfg)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# The LM's scans: the kernels' plain versions against the jnp scans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference_associative_scan(with_h0):
    rng = np.random.default_rng(9)
    B, S, D = 2, 96, 48
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) if with_h0 else None
    want = np.asarray(ref_rglru.rglru_scan(
        jnp.asarray(a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0)))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    _close(got.numpy(), want)


def test_ssd_chunked_matches_reference_scan():
    rng = np.random.default_rng(10)
    b, s, h, p, n, chunk = 2, 96, 4, 8, 16, 32
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    args = (x, dt, A, Bm, Cm)
    y_r, h_r = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    y_t, h_t = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(y_t.numpy(), np.asarray(y_r))
    _close(h_t.numpy(), np.asarray(h_r))
    # the final state is where a decode picks up: one more step of each
    st_r, st_t = jnp.asarray(h_r), h_t
    xs, dts = x[:, -1], dt[:, -1]
    yd_r, _ = ref_ssm.ssd_decode_step(st_r, jnp.asarray(xs), jnp.asarray(dts),
                                      jnp.asarray(A), jnp.asarray(Bm[:, -1]),
                                      jnp.asarray(Cm[:, -1]))
    yd_t, _ = ssm.ssd_decode_step(st_t, *map(torch.from_numpy, (
        xs, dts, A, Bm[:, -1], Cm[:, -1])))
    _close(yd_t.numpy(), np.asarray(yd_r))


@pytest.mark.parametrize("arch,lib", [("recurrentgemma-9b", "rglru"),
                                      ("mamba2-780m", "ssd")])
def test_lm_forward_calls_the_scan_kernels_wrapper(smoke_pair, monkeypatch,
                                                   arch, lib):
    """The forward reaches the kernels' wrappers (the plain versions on
    the CPU): once per recurrent block."""
    import repro_torch.kernels.rglru.ops as rops
    import repro_torch.kernels.ssd.ops as sops
    mod, name = (rops, "rglru") if lib == "rglru" else (sops, "ssd_states")
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rcfg, cfg, rp, tp = smoke_pair(arch)
    tb = M.make_batch(cfg, batch=2, seq=64, kind="prefill", seed=2,
                      device="cpu")
    M.forward(tp, tb, cfg)
    assert len(calls) == sum(k == ("rglru" if lib == "rglru" else "ssm")
                             for k in cfg.block_pattern * (
                                 cfg.n_layers // len(cfg.block_pattern)))
