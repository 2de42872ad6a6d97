"""The port's placement helpers, ``shard_map`` with its in-step
collectives, ``compressed_allreduce`` and the mesh forms of the
``REPRO_*`` switches, against the JAX reference on the CPU.

* ``use_mesh`` / ``current_mesh``, ``NamedSharding``,
  ``param_shardings`` (specs equal to the reference's ``param_specs`` on a
  mesh of the same shape), ``as_shardings``, ``replicated``, ``place``
  (every position's shard its spec's slice) and ``gather`` bit for bit.
* ``shard_map`` over eight positions of a (8,) or 4 x 2 CPU mesh with
  ``psum``, ``pmax`` and ``all_gather`` over named axes, held to the
  reference's collectives under ``jax.vmap(worker, axis_name=...)`` (the
  reference's ``shard_map`` needs one device a position; ``vmap`` names
  the same axis in one process): bit for bit.
* ``compressed_allreduce`` under the port's ``shard_map`` over eight
  positions against the reference's under ``vmap``: the sums and the
  error feedback bit for bit, and within 0.02 of the plain sum, as
  ``tests/test_distributed.py`` holds the reference.
* ``build_train_step(compress_grads=True, dp_axes=("data",))`` under the
  port's ``shard_map`` over two data positions against the reference's
  step under ``vmap``: losses and parameters within the bands of
  ``tests/test_torch_training.py``; m and v within one int8 step a
  position of their scale (``QUANT_BAND``: float gradients a rounding
  level apart may round to neighbouring steps), and equal within 1e-5 of
  their scale at 99 % of the elements or more.
* ``REPRO_ATTN_SEQSHARD`` and ``REPRO_ATTN_OPT`` (module globals patched
  in both packages) through ``jit_prefill_step`` at (2, 4096), where the
  attention is blockwise, against the reference's ``jit_prefill_step``
  under the same switches; ``REPRO_DECODE_WSTAT`` (patched in both)
  through ``jit_serve_step``, where the port contracts its dense weights
  where they lie over ``data``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import generator as ref_gen  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_tl  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import generator as gen  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

SCALE_BAND = 1e-5
PARAM_ATOL = 5e-5
QUANT_BAND = 2 / 127         # an int8 step on each of two positions
OC = dict(warmup_steps=2, total_steps=10)


def _mesh(shape, axes=("data", "model")):
    return make_debug_mesh(shape, axes, device="cpu")


def _ref_mesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


# --------------------------------------------------------------------------
# placement helpers
# --------------------------------------------------------------------------


def test_use_mesh_is_ambient_and_nests():
    a, b = _mesh((2, 2)), _mesh((4, 2))
    assert S.current_mesh() is None
    with S.use_mesh(a) as m:
        assert m is a and S.current_mesh() is a
        with S.use_mesh(b):
            assert S.current_mesh() is b
        assert S.current_mesh() is a
    assert S.current_mesh() is None
    x = torch.ones(3)
    with S.use_mesh(b):
        assert S.shard_hint(x, S.BATCH, "model") is x


def test_param_shardings_are_the_references_specs():
    """``param_shardings`` / ``as_shardings`` / ``replicated`` give the
    reference's specs on a mesh of the same shape (the reference reads
    only ``.shape`` and ``.axis_names`` of the mesh)."""
    mesh = _mesh((4, 2))
    cfg, rcfg = get_config("mixtral-8x22b").smoke(), ref_get_config(
        "mixtral-8x22b").smoke()
    shapes = jax.eval_shape(lambda: ref_tf.init_params(
        rcfg, jax.random.PRNGKey(0)))
    want = ref_sharding.param_specs(shapes, mesh, rcfg)
    got = S.param_shardings(tf.param_shapes(cfg), mesh, cfg)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, spec in flat_want.items():
        key = [getattr(k, "key", getattr(k, "idx", k)) for k in path]
        leaf = got
        for k in key:
            leaf = leaf[k]
        assert isinstance(leaf, S.NamedSharding) and leaf.mesh is mesh
        assert tuple(leaf.spec) == tuple(spec), key
    specs = {"a": S.P("data"), "b": None, "c": (S.P(), S.P("model"))}
    sh = S.as_shardings(specs, mesh)
    assert sh["b"] is None and sh["a"] == S.NamedSharding(mesh, S.P("data"))
    assert sh["c"][1].spec == ("model",)
    assert S.replicated(mesh) == S.NamedSharding(mesh, S.P())
    from jax.sharding import PartitionSpec as JP
    ref = ref_sharding.as_shardings(
        {"a": JP("data"), "b": None, "c": (JP(), JP("model"))}, _ref_mesh())
    assert ref["b"] is None
    assert tuple(ref["a"].spec) == tuple(sh["a"].spec)
    assert [tuple(r.spec) for r in ref["c"]] == [tuple(x.spec)
                                                for x in sh["c"]]
    assert tuple(ref_sharding.replicated(_ref_mesh()).spec) == tuple(
        S.replicated(mesh).spec)


def test_place_splits_and_gather_is_bit_for_bit():
    mesh = _mesh((4, 2))
    x = torch.randn((8, 6, 4), generator=torch.Generator().manual_seed(0))
    a = S.place(x, S.NamedSharding(mesh, S.P("data", None, "model")))
    assert len(a.shards) == 8 and a.shape == (8, 6, 4)
    for p, s in enumerate(a.shards):
        c = mesh.coords(p)
        assert torch.equal(s, x[2 * c["data"]:2 * c["data"] + 2, :,
                               2 * c["model"]:2 * c["model"] + 2])
    assert torch.equal(a.gather(), x) and np.array_equal(np.asarray(a),
                                                         x.numpy())
    both = S.place(x, S.NamedSharding(mesh, S.P(("data", "model"))))
    assert [tuple(s.shape) for s in both.shards] == [(1, 6, 4)] * 8
    assert torch.equal(both.shards[3], x[3:4])       # data major, model minor
    rep = S.place({"w": x}, S.replicated(mesh))["w"]
    assert all(torch.equal(s, x) and s.data_ptr() != x.data_ptr()
               for s in rep.shards)
    assert S.place(a, a.sharding) is a
    again = S.place(a, S.NamedSharding(mesh, S.P(None, None, "model")))
    assert torch.equal(again.gather(), x)
    with pytest.raises(S.ShardingSpecError):
        S.place(torch.ones(3), S.NamedSharding(mesh, S.P("data")))


# --------------------------------------------------------------------------
# shard_map and the in-step collectives
# --------------------------------------------------------------------------


def test_collectives_under_shard_map_match_vmap():
    g = np.random.default_rng(1).standard_normal((8, 5)).astype(np.float32)

    def ours(x):
        return (C.psum(x, "data"), C.pmax(x, ("data",)),
                C.all_gather(x[0], "data"))

    def theirs(x):
        return (jax.lax.psum(x, "data"), jax.lax.pmax(x, "data"),
                jax.lax.all_gather(x, "data"))

    mesh = _mesh((8,), ("data",))
    got = S.shard_map(ours, mesh=mesh, in_specs=S.P("data"),
                      out_specs=(S.P(), S.P(), S.P()), check_vma=False)(
        torch.from_numpy(g))
    want = jax.vmap(theirs, axis_name="data")(jnp.asarray(g))
    assert np.array_equal(got[0][0].numpy(), np.asarray(want[0][0]))
    assert np.array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2][0]))


def test_collectives_reduce_over_the_named_axis_only():
    """On 4 x 2 a psum over ``data`` sums the four positions that share a
    ``model`` coordinate; over both axes, all eight."""
    mesh = _mesh((4, 2))
    x = torch.arange(8.0).reshape(4, 2)

    def worker(t):
        return C.psum(t, "data"), C.psum(t, ("data", "model"))

    over_data, over_all = S.shard_map(
        worker, mesh=mesh, in_specs=S.P("data", "model"),
        out_specs=(S.P(None, "model"), S.P()))(x)
    assert torch.equal(over_data, x.sum(0, keepdim=True))
    assert float(over_all) == float(x.sum())
    with pytest.raises(NameError, match="unbound axis"):
        C.psum(x, "data")
    with pytest.raises(NameError, match="pod"):
        S.shard_map(lambda t: C.psum(t, "pod"), mesh=mesh,
                    in_specs=S.P("data"), out_specs=S.P("data"))(x)


def test_rendezvous_loses_no_value_under_contention():
    """Sixteen position threads (more than this machine's cores share)
    with a short switch interval, 200 rounds of psum / pmax each: every
    round's result is exact, so no slot was overwritten before every
    position read it."""
    import sys
    mesh = _mesh((16,), ("data",))
    rounds = 200

    def worker(x):
        p = int(x[0])
        out = []
        for r in range(rounds):
            v = torch.tensor(float(p * rounds + r))
            out.append(float(C.psum(v, "data")) == sum(
                q * rounds + r for q in range(16))
                and float(C.pmax(v, "data")) == 15 * rounds + r)
        return torch.tensor([all(out)])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ok = S.shard_map(worker, mesh=mesh, in_specs=S.P("data"),
                         out_specs=S.P("data"))(torch.arange(16.0))
    finally:
        sys.setswitchinterval(old)
    assert bool(ok.all())


def test_compressed_allreduce_matches_reference():
    g = (np.random.default_rng(3).standard_normal((8, 64)) * 1e-2).astype(
        np.float32)

    def ours(x):
        red, st = comp.compressed_allreduce({"g": x[0]}, {}, ("data",))
        return red["g"][None], st["ef"]["g"][None]

    def theirs(x):
        red, st = ref_comp.compressed_allreduce({"g": x}, {}, ("data",))
        return red["g"], st["ef"]["g"]

    red, ef = S.shard_map(ours, mesh=_mesh((8,), ("data",)),
                          in_specs=S.P("data"),
                          out_specs=(S.P("data"), S.P("data")))(
        torch.from_numpy(g))
    rred, ref_ef = jax.vmap(theirs, axis_name="data")(jnp.asarray(g))
    assert np.array_equal(red.numpy(), np.asarray(rred))
    assert np.array_equal(ef.numpy(), np.asarray(ref_ef))
    want = g.sum(0)
    assert np.abs(red.numpy()[0] - want).max() / np.abs(want).max() < 0.02


def test_compressed_train_step_under_shard_map_matches_reference():
    """Two data positions, each a row of the batch: the compressed step's
    losses, parameters, m, v and error feedback against the reference's
    step under ``vmap`` (params and state replicated in, one copy a
    position out)."""
    arch = "mamba2-780m"
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    data = dict(seq_len=32, global_batch=2, seed=0, mean_doc_len=16)
    b = SyntheticLM(cfg, DataConfig(**data)).batch(0)
    assert all(np.array_equal(v, RefSyntheticLM(
        rcfg, RefDataConfig(**data)).batch(0)[k]) for k, v in b.items())
    rstep = ref_tl.build_train_step(rcfg, ref_opt.OptConfig(**OC),
                                    compress_grads=True, dp_axes=("data",))
    rb = {k: jnp.asarray(v)[:, None] for k, v in b.items()}
    rp2, ro2, rm = jax.jit(jax.vmap(rstep, in_axes=(None, None, 0),
                                    axis_name="data"))(
        rp, ref_opt.adamw_init(rp), rb)
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    step = tl.build_train_step(cfg, opt.OptConfig(**OC), compress_grads=True,
                               dp_axes=("data",))
    mesh = _mesh((2,), ("data",))

    def worker(batch):
        p = tree_map(torch.clone, tp)
        p2, o2, m = step(p, opt.adamw_init(p), batch)
        return p2, o2, m["loss"][None]

    tp2, to2, loss = S.shard_map(
        worker, mesh=mesh, in_specs=S.P("data"),
        out_specs=(S.P(), S.P(), S.P("data")))(
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(rm["loss"]),
                               rtol=1e-6)
    # AdamW's new state is {"m", "v", "step"} in both packages
    assert set(to2) == set(ro2) == {"m", "v", "step"}
    got = {"p": tp2, "m": to2["m"], "v": to2["v"]}
    want = jax.device_get({"p": jax.tree.map(lambda a: a[0], rp2),
                           "m": jax.tree.map(lambda a: a[0], ro2["m"]),
                           "v": jax.tree.map(lambda a: a[0], ro2["v"])})
    # A gradient a rounding level apart can round to the neighbouring int8
    # step on a position, so the summed gradient may differ by one step
    # (amax / 127) a position where the two packages' float gradients
    # straddle a half step: m by (1 - b1) of that, v by twice its share.
    for a, w in zip(tree_leaves(got["p"]), jax.tree.leaves(want["p"])):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w),
                                   rtol=0, atol=PARAM_ATOL)
    flips = total = 0
    for key, band in (("m", QUANT_BAND), ("v", 2 * QUANT_BAND)):
        for a, w in zip(tree_leaves(got[key]), jax.tree.leaves(want[key])):
            a, w = a.float().numpy(), np.asarray(w, np.float32)
            assert _rel(a, w) <= band, key
            scale = np.abs(w).max()
            flips += int((np.abs(a - w) > SCALE_BAND * scale).sum())
            total += w.size
    assert flips <= 0.01 * total, (flips, total)


# --------------------------------------------------------------------------
# the REPRO_* switches on a mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("switches", [("_ATTN_SEQSHARD",),
                                      ("_ATTN_OPT", "_ATTN_SEQSHARD")])
def test_attention_switches_on_a_mesh_match_reference(monkeypatch, switches):
    """The sharded prefill at (2, 4096) on a 2 x 2 mesh (blockwise
    attention, eight q blocks) against the reference's
    ``jit_prefill_step`` under the same switches: the port splits the q
    block groups over its two model positions (``REPRO_ATTN_SEQSHARD``),
    each repeating its KV heads to its query heads (``REPRO_ATTN_OPT``)."""
    for name in switches:
        for mod in (ref_layers, layers):
            monkeypatch.setattr(mod, name, True)
    arch = "gpt2-medium"
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    batch = RM.make_batch(rcfg, batch=2, seq=4096, kind="prefill")
    with ref_sharding.use_mesh(_ref_mesh()):
        want = np.asarray(ref_gen.jit_prefill_step(
            rcfg, _ref_mesh(), rp, batch)(rp, batch))
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    tb = {k: np.asarray(v) for k, v in batch.items()}
    got = gen.jit_prefill_step(cfg, _mesh((2, 2)), tp, tb)(tp, tb)
    assert _rel(got.numpy(), want) <= SCALE_BAND


def test_decode_wstat_on_a_mesh_matches_reference(monkeypatch):
    """The weight-stationary decode (``REPRO_DECODE_WSTAT``) in both
    packages: the reference's placement hint over ``data`` against the
    port's sharded serve step contracting each dense weight's FSDP shards
    where they lie, the partial sums summed over ``data``."""
    monkeypatch.setattr(ref_tf, "_DECODE_WSTAT", True)
    monkeypatch.setattr(tf, "_DECODE_WSTAT", True)
    arch = "recurrentgemma-9b"
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    rcache = ref_tf.init_cache(rcfg, 8, 16)
    rstep = ref_gen.jit_serve_step(rcfg, _ref_mesh(), rp, rcache)
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    cache = tf.init_cache(cfg, 8, 16, device="cpu")
    step = gen.jit_serve_step(cfg, _mesh((4, 2)), tp, cache)
    rtok = jnp.arange(8, dtype=jnp.int32)
    tok = np.arange(8, dtype=np.int32)
    for _ in range(3):
        with ref_sharding.use_mesh(_ref_mesh()):
            rtok, rlog, rcache = rstep(rp, rtok, rcache)
        tok, log, cache = step(tp, tok, cache)
        assert np.array_equal(np.asarray(tok), np.asarray(rtok))
        assert _rel(log.numpy(), np.asarray(rlog)) <= SCALE_BAND
