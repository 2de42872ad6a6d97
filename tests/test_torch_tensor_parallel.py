"""Tensor-parallel compute over ``model`` in the port's sharded steps,
against the JAX reference on the CPU.

The reference's GSPMD places heads, ``d_ff``, experts, SSM heads, RG-LRU
channels and vocab over ``model`` and computes each position's part of
them; the port's lockstep executor does the same (``distributed/spmd.py``:
a compute unit is a data block and a model position, each weight gathered
over ``data`` only).  At ``smoke()`` on (1, 2) and (2, 2)
``make_debug_mesh(device="cpu")`` meshes, from the reference's parameters
(``params_from_numpy``), against the reference's own ``jit_*_step`` on a
1 x 1 ``jax.sharding.Mesh`` and against the port's unsharded steps, with
the bands of ``tests/test_torch_gspmd.py`` and
``tests/test_torch_gspmd_serve.py``:

* every block kind — attention with its KV heads split (gpt2-medium,
  mixtral-8x22b), MQA with K/V whole and the decode cache split over its
  sequence (recurrentgemma-9b), dense and gated FFN, MoE expert-parallel
  (mixtral, four experts over two positions) and ffn-split (two experts
  over four positions, where the KV heads do not divide either), Mamba-2,
  RG-LRU and whisper's cross-attention — through the prefill, train and
  serve steps; every leaf split over ``model`` is used split (no gather
  over ``model`` but the named whole weights);
* the vocab-parallel cross-entropy against ``logsumexp``, value and
  gradient;
* decode steps with ``PlacedArray.gather`` made to raise on every cache
  leaf: the cache is read and written where it lies;
* the cost walker's ``flops_per_device`` on a (1, 2) meta mesh for
  gpt2-medium and mamba2-780m, against the products of the config's
  shapes worked out here: split layers at half, replicated parts whole;
  and its train-step ``collective`` record against the collectives of
  both passes counted from the shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed.sharding import use_mesh as ref_use_mesh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import generator as ref_gen  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_tl  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (PlacedArray,  # noqa: E402
                                              as_shardings, cache_specs,
                                              place)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_paths  # noqa: E402
from repro_torch.serving import generator as gen  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

SCALE_BAND = 1e-5            # tests/test_torch_gspmd_serve.py
LOSS_RTOL = 1e-6             # tests/test_torch_gspmd.py
GRAD_BAND = 1e-5
PARAM_ATOL = 5e-5
OC = dict(warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 32
# the train steps' batches, as tests/test_torch_gspmd.py draws them
DATA = dict(seq_len=SEQ, global_batch=BATCH, seed=0, mean_doc_len=16)
SLOTS, CACHE, DECODE_STEPS = 4, 16, 3
ARCHS = ("gpt2-medium", "mamba2-780m", "recurrentgemma-9b", "mixtral-8x22b")
MESHES = ((1, 2), (2, 2))
# The leaves read whole on every model position: Mamba-2's packed
# in_proj / conv, and K/V where the KV heads do not divide.
WHOLE = {"mamba2-780m": ("in_proj/w", "ssm/conv"),
         "recurrentgemma-9b": ("wk/w", "wv/w")}


def _ref_mesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _mesh(shape):
    return make_debug_mesh(shape, ("data", "model"), device="cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _np(t):
    if isinstance(t, PlacedArray):
        t = t.gather()
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind in "fV" else a


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: _np(tree)}


def _cfgs(name):
    """(reference cfg, port cfg) at smoke(); ``mixtral-ffn-split`` is
    mixtral with two experts, fewer than four model positions."""
    arch = "mixtral-8x22b" if name == "mixtral-ffn-split" else name
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    if name == "mixtral-ffn-split":
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, num_experts=2))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=2))
    return rcfg, cfg


_REF: dict = {}


def _reference(name):
    """The reference's parameters and its prefill, train and serve results
    on a 1 x 1 mesh (once per arch)."""
    if name in _REF:
        return _REF[name]
    rcfg, cfg = _cfgs(name)
    rmesh = _ref_mesh()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    rp_np = jax.device_get(rp)
    out = {"cfg": cfg, "params": rp_np}
    pre = RM.make_batch(rcfg, batch=BATCH, seq=SEQ, kind="prefill")
    with ref_use_mesh(rmesh):
        out["prefill"] = (jax.device_get(pre), np.asarray(
            ref_gen.jit_prefill_step(rcfg, rmesh, rp, pre)(rp, pre)))
    source = SyntheticLM(cfg, DataConfig(**DATA))
    trains = [{k: jnp.asarray(v) for k, v in source.batch(i).items()}
              for i in range(2)]
    step = ref_tl.jit_train_step(rcfg, rmesh, rp, trains[0],
                                 ref_opt.OptConfig(**OC))
    p, o = rp, ref_opt.adamw_init(rp)
    losses = []
    with ref_use_mesh(rmesh):
        for b in trains:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
    out["train"] = ([jax.device_get(b) for b in trains], losses,
                    _flat(jax.device_get({"p": p, "m": o["m"],
                                          "v": o["v"]})))
    rcache = ref_tf.init_cache(rcfg, SLOTS, CACHE)
    if rcfg.enc_dec:
        # the encoder output the decode attends to, drawn once; every leaf
        # its own buffer, as the serve step donates them
        out["enc_out"] = np.random.default_rng(1).standard_normal(
            np.shape(rcache["enc_out"])).astype(np.float32)
        rcache = jax.tree.map(lambda a: jnp.array(np.asarray(a)), dict(
            rcache, enc_out=jnp.asarray(out["enc_out"],
                                        rcache["enc_out"].dtype)))
    sstep = ref_gen.jit_serve_step(rcfg, rmesh, rp, rcache)
    tok = jnp.asarray(np.arange(SLOTS, dtype=np.int32) * 7 % 50)
    toks, logits = [], []
    with ref_use_mesh(rmesh):
        for _ in range(DECODE_STEPS):
            tok, lg, rcache = sstep(rp, tok, rcache)
            toks.append(np.asarray(tok))
            logits.append(np.asarray(lg))
    out["serve"] = (toks, logits, _flat(jax.device_get(rcache)))
    _REF[name] = out
    return out


def _params(ref):
    return M.params_from_numpy(ref["params"], device="cpu")


def _cache(ref):
    """The port's empty decode cache for the reference's serve steps (its
    encoder output where the arch has one)."""
    cfg = ref["cfg"]
    cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
    if "enc_out" in ref:
        cache["enc_out"].copy_(torch.from_numpy(ref["enc_out"]))
    return cache


def _serves_as_reference(ref, step, cache):
    """The reference's serve steps through ``step`` from ``cache``: the
    same tokens, the logits and the last cache within SCALE_BAND."""
    toks, logits, want = ref["serve"]
    tok = np.arange(SLOTS, dtype=np.int32) * 7 % 50
    for rtok, rlog in zip(toks, logits):
        tok, lg, cache = step(tok, cache)
        assert np.array_equal(np.asarray(tok), rtok)
        assert _rel(lg.numpy(), rlog) <= SCALE_BAND
    got = _flat(cache)
    for k, v in want.items():
        assert (int(got[k]) == int(v) == DECODE_STEPS if k.endswith("pos")
                else _rel(got[k], v) <= SCALE_BAND), k


@pytest.fixture
def split_gathers(monkeypatch):
    """Every leaf the step gathers over ``model`` (path suffixes), and how
    many parts it split."""
    seen = {"whole": [], "split": 0}
    real_gather = PlacedArray.gather
    real_local = spmd._model_local

    def gather(self, device=None):
        if "model" in str(self.sharding.spec):
            seen["whole"].append(self)
        return real_gather(self, device)

    def local(a, m, dim):
        seen["split"] += 1
        return real_local(a, m, dim)

    monkeypatch.setattr(PlacedArray, "gather", gather)
    monkeypatch.setattr(spmd, "_model_local", local)
    return seen


def _whole_paths(seen, placed_params):
    ids = {id(a): path for path, a in tree_paths(placed_params, "").items()}
    return sorted({ids[id(a)] for a in seen["whole"] if id(a) in ids})


def _assert_split(name, seen, placed):
    assert seen["split"] > 0
    allowed = WHOLE.get(name, ())
    for path in _whole_paths(seen, placed):
        assert path.endswith(allowed), path


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_prefill_computes_split_and_matches(name, shape,
                                                    split_gathers):
    ref = _reference(name)
    cfg, (batch, want) = ref["cfg"], ref["prefill"]
    tp = _params(ref)
    mesh = _mesh(shape)
    step = gen.jit_prefill_step(cfg, mesh, tp, batch)
    placed = place(tp, step.pshard)
    got = step(placed, batch)
    _assert_split(name, split_gathers, placed)
    assert _rel(got.numpy(), want) <= SCALE_BAND
    plain = tf.prefill(tp, {k: torch.from_numpy(np.array(v))
                            for k, v in batch.items()}, cfg)
    assert _rel(got.numpy(), plain.numpy()) <= SCALE_BAND


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_train_steps_compute_split_and_match(name, shape):
    ref = _reference(name)
    cfg = ref["cfg"]
    batches, losses, want = ref["train"]
    tp = _params(ref)
    step = tl.jit_train_step(cfg, _mesh(shape), tp, batches[0],
                             opt.OptConfig(**OC))
    p, s = tp, opt.adamw_init(tp)
    for b, loss in zip(batches, losses):
        p, s, m = step(p, s, b)
        assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    got = _flat({"p": p, "m": s["m"], "v": s["v"]})
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("/p"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
        else:
            assert _rel(got[k], v) <= GRAD_BAND, k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ARCHS)
def test_sharded_serve_steps_compute_split_and_match(name, shape):
    ref = _reference(name)
    cfg = ref["cfg"]
    tp = _params(ref)
    cache = _cache(ref)
    step = gen.jit_serve_step(cfg, _mesh(shape), tp, cache)
    _serves_as_reference(ref, lambda t, c: step(tp, t, c), cache)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_train_step_on_random_labels_matches_reference(name):
    """One train step on ``make_batch``'s uniformly random labels, on (1, 2)
    and (2, 2), against the reference's 1 x 1 step: loss, parameters, m and
    v within the bands above.  (The two-step tests above take SyntheticLM
    batches, as ``tests/test_torch_gspmd.py`` does.  On these labels some
    gradient elements sit at float32 rounding level, where AdamW's first,
    normalised update may take either sign in the port and the reference
    alike, unsharded too: up to 2.3e-5 in a parameter here, within
    PARAM_ATOL, but enough to move the second step's gradients, and m with
    them, by about 1e-5 of scale; ROADMAP.md Queue 3.)"""
    rcfg, cfg = _cfgs(name)
    rmesh = _ref_mesh()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    batch = jax.device_get(RM.make_batch(rcfg, batch=BATCH, seq=SEQ,
                                         kind="train"))
    step = ref_tl.jit_train_step(rcfg, rmesh, rp, batch,
                                 ref_opt.OptConfig(**OC))
    with ref_use_mesh(rmesh):
        p, o, m = step(rp, ref_opt.adamw_init(rp), batch)
    loss = float(m["loss"])
    want = _flat(jax.device_get({"p": p, "m": o["m"], "v": o["v"]}))
    for shape in MESHES:
        tstep = tl.jit_train_step(cfg, _mesh(shape), tp, batch,
                                  opt.OptConfig(**OC))
        q, s_, mt = tstep(tp, opt.adamw_init(tp), batch)
        assert float(mt["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
        got = _flat({"p": q, "m": s_["m"], "v": s_["v"]})
        for k, v in want.items():
            assert (np.abs(got[k] - v).max() <= PARAM_ATOL
                    if k.startswith("/p") else _rel(got[k], v) <= GRAD_BAND), (
                shape, k)


def test_moe_ffn_split_with_fewer_experts_than_positions(split_gathers):
    """Two experts over four model positions: the experts' d_ff is split
    (``param_specs``' rule), and the two KV heads, which do not divide,
    are computed whole and repeated to each position's query head."""
    name = "mixtral-ffn-split"
    ref = _reference(name)
    cfg = ref["cfg"]
    tp = _params(ref)
    mesh = _mesh((1, 4))
    batch, want = ref["prefill"]
    step = gen.jit_prefill_step(cfg, mesh, tp, batch)
    placed = place(tp, step.pshard)
    assert _rel(step(placed, batch).numpy(), want) <= SCALE_BAND
    assert placed["groups"]["b0_attn"]["mlp"]["w_in"].sharding.spec == (
        None, None, "data", "model")
    assert sorted(p.rsplit("/", 2)[-2] for p in _whole_paths(
        split_gathers, placed)) == ["wk", "wv"]
    batches, losses, want_t = ref["train"]
    tstep = tl.jit_train_step(cfg, mesh, tp, batches[0], opt.OptConfig(**OC))
    p, s = tp, opt.adamw_init(tp)
    for b, loss in zip(batches, losses):
        p, s, m = tstep(p, s, b)
        assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    got = _flat({"p": p, "m": s["m"], "v": s["v"]})
    for k, v in want_t.items():
        assert (np.abs(got[k] - v).max() <= PARAM_ATOL if k.startswith("/p")
                else _rel(got[k], v) <= GRAD_BAND), k
    cache = _cache(ref)
    sstep = gen.jit_serve_step(cfg, mesh, tp, cache)
    _serves_as_reference(ref, lambda t, c: sstep(tp, t, c), cache)


def test_cross_attention_splits_heads(split_gathers):
    """whisper-large-v3 (encoder, decoder self- and cross-attention) on
    (1, 2): prefill, train and decode against the reference's steps."""
    name = "whisper-large-v3"
    ref = _reference(name)
    cfg = ref["cfg"]
    tp = _params(ref)
    mesh = _mesh((1, 2))
    batch, want = ref["prefill"]
    step = gen.jit_prefill_step(cfg, mesh, tp, batch)
    placed = place(tp, step.pshard)
    assert _rel(step(placed, batch).numpy(), want) <= SCALE_BAND
    assert _whole_paths(split_gathers, placed) == []
    batches, losses, _ = ref["train"]
    tstep = tl.jit_train_step(cfg, mesh, tp, batches[0], opt.OptConfig(**OC))
    p, s = tp, opt.adamw_init(tp)
    for b, loss in zip(batches, losses):
        p, s, m = tstep(p, s, b)
        assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    cache = _cache(ref)
    sstep = gen.jit_serve_step(cfg, mesh, tp, cache)
    _serves_as_reference(ref, lambda t, c: sstep(tp, t, c), cache)


def test_vocab_parallel_cross_entropy_is_logsumexp():
    gen_ = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 5, 64, generator=gen_, dtype=torch.float64) * 4
    labels = torch.randint(0, 64, (3, 5), generator=gen_)
    want_l = logits.clone().requires_grad_(True)
    want = (torch.logsumexp(want_l, -1) - torch.gather(
        want_l, -1, labels[..., None])[..., 0])
    got_l = logits.clone().requires_grad_(True)
    got = layers.vocab_parallel_nll(list(got_l.chunk(4, -1)), labels)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    got.sum().backward()
    want.sum().backward()
    torch.testing.assert_close(got_l.grad, want_l.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_never_gathers_the_cache(name, monkeypatch):
    """The reference's decode steps on (2, 2) with ``PlacedArray.gather``
    raising on every cache leaf: each position reads and writes its cache
    shards where they lie (mixtral's MoE block spans both data shards,
    which decode their cache rows apart), and the tokens, logits and cache
    are the reference's 1 x 1 serve step's."""
    ref = _reference(name)
    cfg = ref["cfg"]
    tp = _params(ref)
    mesh = _mesh((2, 2))
    cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
    placed = place(cache, as_shardings(cache_specs(cache, mesh, cfg), mesh))
    ids = {id(a) for a in tree_leaves(placed)}
    real = PlacedArray.gather

    def gather(self, device=None):
        if id(self) in ids:
            raise AssertionError(f"the decode gathered a cache leaf {self!r}")
        return real(self, device)

    step = gen.jit_serve_step(cfg, mesh, tp, cache)

    def no_gather(t, c):
        monkeypatch.setattr(PlacedArray, "gather", gather)
        try:
            return step(tp, t, c)
        finally:
            monkeypatch.setattr(PlacedArray, "gather", real)

    _serves_as_reference(ref, no_gather, placed)


def _prefill_flops(cfg, B, S, n) -> float:
    """The products a position computes in ``cfg``'s prefill at (B, S) on
    ``n`` model positions, from the config's shapes: every split layer at
    1 / n, the parts every position computes whole."""
    T, D, V = B * S, cfg.d_model, cfg.padded_vocab
    f = 2.0 * T * D * V / n                                   # the head
    for _ in range(cfg.n_layers):
        if cfg.ssm is None:                                   # attention
            hq, hkv, hd = cfg.n_heads / n, cfg.n_kv_heads / n, cfg.hd
            f += 2.0 * T * D * (hq + 2 * hkv) * hd            # q, k, v
            f += 2 * 2.0 * B * hq * S * S * hd                # scores, pv
            f += 2.0 * T * hq * hd * D                        # wo
            f += 2 * 2.0 * T * D * cfg.d_ff / n               # the FFN
            continue
        s = cfg.ssm
        d_in = D * s.expand
        h, P, N, q = d_in / s.head_dim / n, s.head_dim, s.d_state, s.chunk
        nc = S // min(q, S)
        q = min(q, S)
        f += 2.0 * T * D * (2 * d_in / n + 2 * N + h)         # in_proj
        f += 2.0 * B * nc * q * q * N                         # C·Bᵀ, whole
        f += 2.0 * B * nc * h * q * q * P                     # y_diag
        f += 2 * 2.0 * B * nc * h * P * N * q                 # states, y_off
        f += 2.0 * nc * B * h * P * N                         # the scan
        f += 2.0 * T * (d_in / n) * D                         # out_proj
    return f


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
def test_walker_flops_per_device_follow_the_split(arch):
    cfg = get_config(arch).smoke()
    shape = ShapeSpec("prefill_32k", 64, 4, "prefill")
    rec = dryrun.run_cell(arch, shape.name, "1x2",
                          mesh=dryrun.meta_mesh((1, 2), ("data", "model")),
                          cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["replicated_model_compute"] is False
    want = _prefill_flops(cfg, 4, 64, 2)
    assert abs(rec["flops_per_device"] - want) <= 0.01 * want, (
        rec["flops_per_device"], want)
    one = dryrun.run_cell(arch, shape.name, "1x1",
                          mesh=dryrun.meta_mesh((1, 1), ("data", "model")),
                          cfg=cfg, shape=shape)
    assert abs(one["flops_per_device"] - _prefill_flops(cfg, 4, 64, 1)) \
        <= 0.01 * one["flops_per_device"]
    assert rec["collective"]["all-reduce"] > 0


def test_wstat_decode_leaves_the_dense_weights_where_they_lie(monkeypatch):
    """``REPRO_DECODE_WSTAT`` on (2, 2): no dense weight read through
    ``linear`` is gathered (each position contracts its FSDP shard, the
    partial sums summed over ``data``); the token and logits are the
    reference's 1 x 1 serve step's, within its band."""
    monkeypatch.setattr(tf, "_DECODE_WSTAT", True)
    ref = _reference("gpt2-medium")
    cfg = ref["cfg"]
    tp = _params(ref)
    mesh = _mesh((2, 2))
    cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
    step = gen.jit_serve_step(cfg, mesh, tp, cache)
    placed = place(tp, step.pshard)
    paths = {id(a): p for p, a in tree_paths(placed, "").items()}
    gathered = []
    real = PlacedArray.gather

    def gather(self, device=None):
        gathered.append(paths.get(id(self), ""))
        return real(self, device)

    monkeypatch.setattr(PlacedArray, "gather", gather)
    toks, logits, _ = ref["serve"]
    tok = np.arange(SLOTS, dtype=np.int32) * 7 % 50
    nxt, lg, cache = step(placed, tok, cache)
    assert np.array_equal(np.asarray(nxt), toks[0])
    assert _rel(lg.numpy(), logits[0]) <= SCALE_BAND
    assert not [p for p in gathered if p.endswith("/w")], gathered


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
def test_walker_charges_the_backward_at_each_positions_share(arch):
    """A train step's backward runs each model position's part at that
    position's share too: on (1, 2) a position's FLOPs against one
    position's (1 x 1) are the prefill's ratio, and the whole step's (every
    position on one device, ``flops_one_device``) are the two positions'
    (the products outside the positions' parts — norms, lookups — count no
    FLOPs)."""
    cfg = get_config(arch).smoke()
    recs = {}
    for kind in ("train", "prefill"):
        shape = ShapeSpec(f"{kind}_smoke", 64, 4, kind)
        for mesh in ((1, 1), (1, 2)):
            recs[kind, mesh] = dryrun.run_cell(
                arch, shape.name, "x".join(map(str, mesh)),
                mesh=dryrun.meta_mesh(mesh, ("data", "model")), cfg=cfg,
                shape=shape, accum=1)
            assert recs[kind, mesh]["status"] == "ok"

    def ratio(kind):
        return (recs[kind, (1, 2)]["flops_per_device"]
                / recs[kind, (1, 1)]["flops_per_device"])

    assert ratio("train") == pytest.approx(ratio("prefill"), rel=0.01)
    assert ratio("train") < 0.6
    two = recs["train", (1, 2)]
    assert two["flops_one_device"] == pytest.approx(
        2 * two["flops_per_device"], rel=0.01)


def _train_collectives(cfg, B, S, n) -> dict:
    """The link bytes a position moves in ``cfg``'s train step at (B, S) on
    a (1, ``n``) mesh, by collective, from the config's shapes and the
    ring formulas (an all-reduce of X moves 2(n−1)/n·X, an all-gather of
    X (n−1)/n·X, a reduce-scatter of X into shards of X/n as much), with
    how many there are (``count``).  Float32 at ``smoke()``.

    The first pass: the vocab-parallel lookup's sum, each row-split
    product's sum (attention's ``wo`` and the FFN's ``w_out``, or
    ``out_proj``), the loss's pmax and two sums over (B, S), the learned
    position table's gather (its d_model split) and Mamba-2's ``in_proj``
    and ``conv`` gathered whole (one gather a leaf of the stacked layers).  The recompute of each checkpointed region
    up to its last saved value: the attention's sum and the loss's three
    (not the block's final sum).  The backward: each activation that the
    positions read through ``_Fan`` (attention's and the FFN's x, the SSM
    block's normed x, the head's x) gets its partials summed, and the
    position table's gather its transpose, a reduce-scatter."""
    D, L, f4 = cfg.d_model, cfg.n_layers, 4.0
    act, small = B * S * D * f4, B * S * f4
    ar, g = 2 * (n - 1) / n, (n - 1) / n
    if cfg.ssm is None:
        reduces = [act] + [act] * 2 * L + [small] * 3       # first pass
        reduces += [act] * L + [small] * 3                  # recompute
        reduces += [act] * (2 * L + 1)                      # backward
        table = S * D * f4
        gathers, scatters = [table], [table]
    else:
        s = cfg.ssm
        d_in = D * s.expand
        in_proj = D * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) * f4
        conv = s.conv_width * (d_in + 2 * s.d_state) * f4
        reduces = [act] + [act] * L + [small] * 3
        reduces += [small] * 3
        reduces += [act] * (L + 1)
        gathers, scatters = [L * in_proj, L * conv], []   # stacked layers
    return {"all-reduce": ar * sum(reduces), "all-gather": g * sum(gathers),
            "reduce-scatter": g * sum(scatters),
            "count": len(reduces) + len(gathers) + len(scatters)}


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
def test_walker_charges_the_backward_collectives(arch):
    """A train step on (1, 2) is charged the collectives its backward runs
    over ``model`` beside its forward's: the float32 sum of each replicated
    activation's gradient partials (an all-reduce) and each all-gather's
    transpose (a reduce-scatter), as the reference's compiled step holds
    them; the record equals the count from the shapes
    (:func:`_train_collectives`)."""
    cfg = get_config(arch).smoke()
    shape = ShapeSpec("train_smoke", 64, 4, "train")
    rec = dryrun.run_cell(arch, shape.name, "1x2",
                          mesh=dryrun.meta_mesh((1, 2), ("data", "model")),
                          cfg=cfg, shape=shape, accum=1)
    assert rec["status"] == "ok", rec.get("traceback")
    want = _train_collectives(cfg, 4, 64, 2)
    got = {k: rec["collective"][k] for k in want}
    assert got == pytest.approx(want, rel=1e-9), (got, want)


# --------------------------------------------------------------------------
# every catalog arch: the units' layout, prefill and decode split over model
# --------------------------------------------------------------------------

from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.distributed.sharding import param_shardings  # noqa: E402

_PARAMS: dict = {}


def _arch_params(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch).smoke()
        _PARAMS[arch] = (cfg, tf.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
    return _PARAMS[arch]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list(ASSIGNED))
def test_unit_params_are_the_specs_model_slices(arch, shape):
    """Every leaf the forms read split over ``model`` (``tp_split``) whose
    spec splits it there reaches the model as ``Shards``: part m is the
    whole leaf's m-th slice along the spec's model dim, gathered over
    ``data``; every other leaf is the whole leaf."""
    cfg, params = _arch_params(arch)
    mesh = _mesh(shape)
    placed = place(params, param_shardings(params, mesh, cfg))
    split = tf.tp_split(cfg, mesh.shape["model"])
    unit = spmd.unit_params(placed, split)
    whole, units, cut = (tree_paths(params, ""), tree_paths(unit, ""),
                         tree_paths(placed, ""))
    n_split = 0
    for path, full in whole.items():
        got = units[path]
        spec = cut[path].sharding.spec
        if "model" in spec and split(path.lstrip("/")):
            d = list(spec).index("model")
            k = full.shape[d] // mesh.shape["model"]
            assert isinstance(got, spmd.Shards) and got.dim == d, path
            for m, part in enumerate(got.parts):
                assert torch.equal(part, full.narrow(d, m * k, k)), path
            n_split += 1
        else:
            assert torch.equal(got, full), path
    assert n_split > 0


@pytest.mark.parametrize("arch", list(ASSIGNED))
def test_every_arch_trains_prefills_and_decodes_split(arch):
    """Each catalog arch's sharded train steps and prefill on (1, 2) and
    decode steps on (2, 2) against the reference's steps on a 1 x 1 mesh,
    within the bands of ``tests/test_torch_gspmd.py`` and
    ``tests/test_torch_gspmd_serve.py`` (qwen1.5-110b and starcoder2-15b
    carry the q / k / v biases that ``param_specs`` leaves whole)."""
    ref = _reference(arch)
    cfg, tp = ref["cfg"], _params(ref)
    batches, losses, want_t = ref["train"]
    step = tl.jit_train_step(cfg, _mesh((1, 2)), tp, batches[0],
                             opt.OptConfig(**OC))
    p, s = tp, opt.adamw_init(tp)
    for b, loss in zip(batches, losses):
        p, s, m = step(p, s, b)
        assert float(m["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    got = _flat({"p": p, "m": s["m"], "v": s["v"]})
    for k, v in want_t.items():
        if k.startswith("/p"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
        else:
            assert _rel(got[k], v) <= GRAD_BAND, k
    batch, want = ref["prefill"]
    got = gen.jit_prefill_step(cfg, _mesh((1, 2)), tp, batch)(tp, batch)
    assert _rel(got.numpy(), want) <= SCALE_BAND
    cache = _cache(ref)
    sstep = gen.jit_serve_step(cfg, _mesh((2, 2)), tp, cache)
    _serves_as_reference(ref, lambda t, c: sstep(tp, t, c), cache)


# --------------------------------------------------------------------------
# the executor's pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [1, 2])
def test_shards_slice_as_the_tensors_they_split(dim):
    """A stacked leaf split over ``model`` is indexed and unbound by layer
    as the whole tensor is: each layer's parts are that layer's slices."""
    full = torch.arange(3 * 4 * 6, dtype=torch.float32).reshape(3, 4, 6)
    parts = list(full.chunk(2, dim))
    sh = spmd.Shards(parts, dim)
    for i, layer in enumerate(sh.unbind(0)):
        assert layer.dim == dim - 1
        assert torch.equal(torch.cat(layer.parts, dim - 1), full[i])
        assert torch.equal(torch.cat(sh[i].parts, dim - 1), full[i])
    with pytest.raises(ValueError):
        spmd.Shards(parts, 0).unbind(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_collectives_reduce_in_position_order(dtype):
    """``group_psum`` is the in-step ``psum`` bit for bit in float32 and
    sums bfloat16 parts in float32, rounding once; ``group_pmax`` and
    ``group_all_gather`` are the elementwise maximum and the
    concatenation in position order."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import P, shard_map
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(5, 7, generator=g).to(dtype) for _ in range(4)]
    want = (xs[0].float() + xs[1].float() + xs[2].float()
            + xs[3].float()).to(dtype)
    assert torch.equal(C.group_psum(xs), want)
    assert torch.equal(C.group_pmax(xs), torch.stack(xs).amax(0))
    assert torch.equal(C.group_all_gather(xs, 1), torch.cat(xs, 1))
    if dtype == torch.float32:
        run = shard_map(lambda x: C.psum(x[0], "model")[None],
                        mesh=_mesh((1, 4)), in_specs=P("model"),
                        out_specs=P("model"))
        assert torch.equal(run(torch.stack(xs))[0], C.group_psum(xs))


def test_cache_view_reads_each_positions_rows_where_they_lie():
    """On (2, 2) a block of one data shard reads each model position's
    cache shard as a view of it (heads split), and a block of both data
    shards reads them as ``Rows``, one a shard."""
    cfg = get_config("gpt2-medium").smoke()
    mesh = _mesh((2, 2))
    cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
    placed = place(cache, as_shardings(cache_specs(cache, mesh, cfg), mesh))
    pos = torch.zeros((), dtype=torch.int32)
    view = spmd.cache_view(placed, 2, 4, pos)
    k = view["groups"]["b0_attn"]["k"]
    shards = placed["groups"]["b0_attn"]["k"].shards
    assert isinstance(k, spmd.Shards) and k.dim == 3 and view["pos"] is pos
    assert [t.data_ptr() for t in k.parts] == [shards[2].data_ptr(),
                                              shards[3].data_ptr()]
    both = spmd.cache_view(placed, 0, 4, pos)["groups"]["b0_attn"]["k"]
    assert isinstance(both, spmd.Rows)
    assert [(lo, hi) for lo, hi, _ in both.blocks] == [(0, 2), (2, 4)]
    assert both.blocks[1][2].parts[1].data_ptr() == shards[3].data_ptr()
