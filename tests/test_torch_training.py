"""The LM training path of the PyTorch port (``repro_torch.training``)
against the JAX reference, on the CPU.

* The optimizer against ``repro.training.optimizer`` on one numpy tree:
  ``lr_at`` over warmup and decay, ``global_norm``, the clip, and three
  ``adamw_update``s (parameters within ``OPT_BAND``, moments and metrics
  too).
* ``build_train_step`` at ``smoke()`` for one arch of each family (dense,
  moe, ssm, hybrid, audio, vlm), from the reference's parameters
  (``params_from_numpy``) and the same ``SyntheticLM`` batches (equal bit
  for bit): ``loss_fn``'s value (rtol ``LOSS_RTOL``) and every gradient
  leaf against ``jax.value_and_grad`` within ``GRAD_BAND`` of its own
  largest value (measured ≤ 2.2e-6); three train steps against the
  reference's jitted step: parameters within ``PARAM_ATOL`` (measured ≤
  1.6e-5: AdamW's m̂/√v̂ of a gradient at the rounding level takes either
  sign, and the largest update of a step is lr·(1 + wd·|p|) ≈ 3.3e-4),
  each step's update p1 − p0 within ``UPDATE_TOL`` in norm, m and v within
  ``GRAD_BAND`` of their scale (measured ≤ 9.4e-6), the losses within
  ``LOSS_RTOL``.
* ``accum=2`` against the reference's ``accum=2`` (ssm and hybrid);
  ``remat`` on and off giving equal values; ``REPRO_BF16_BWD`` and
  ``REPRO_REMAT_POLICY=dots`` against the reference under the same switch
  (module globals patched in both packages).
* The monitors; ``train`` with ``fail_at`` then ``resume`` bit for bit an
  uninterrupted run; ``train_compiled`` / ``resume_compiled`` on
  ``gpt2_block_loss_fn`` at (32, 64) against the reference's and bit for
  bit their own uninterrupted run; the CLI's both paths, ``--fail-at``'s
  exit code 42 and ``--resume``; ``launch.train``'s
  ``DeprecationWarning``; the sharded paths' entry points (held against
  the reference in ``tests/test_torch_gspmd.py``).

The captured step runs only on the card (``chip_smoke.py``'s train
phase); here ``TrainStep`` runs eagerly.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_tl  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import cli  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

FAMILIES = {"dense": "gpt2-medium", "moe": "mixtral-8x22b",
            "ssm": "mamba2-780m", "hybrid": "recurrentgemma-9b",
            "audio": "whisper-large-v3", "vlm": "internvl2-1b"}
LOSS_RTOL = 1e-6
GRAD_BAND = 1e-5             # of each leaf's largest value
OPT_BAND = dict(rtol=1e-6, atol=1e-7)
PARAM_ATOL = 5e-5
UPDATE_TOL = 1e-2
DATA = dict(seq_len=64, global_batch=2, seed=0, mean_doc_len=16)
OC = dict(warmup_steps=2, total_steps=10)
STEPS = 3


def _flat(tree, pre=""):
    """{path: float32 / int numpy} of a nest of dicts of jax arrays or
    tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return {pre: (t.float() if t.is_floating_point() else t).numpy()}
    a = np.asarray(tree)
    return {pre: a.astype(np.float32) if a.dtype.kind in "fV" else a}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _trees_close(got, want, band=GRAD_BAND, prefix=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert _rel(g[k], w[k]) <= band, prefix + k


def _batches(rcfg, cfg, step):
    """The reference's and the port's SyntheticLM batch of ``step``: equal
    bit for bit."""
    rb = RefSyntheticLM(rcfg, RefDataConfig(**DATA)).batch(step)
    tb = SyntheticLM(cfg, DataConfig(**DATA)).batch(step)
    assert rb.keys() == tb.keys()
    for k in rb:
        assert rb[k].dtype == tb[k].dtype and np.array_equal(rb[k], tb[k]), k
    return ({k: jnp.asarray(v) for k, v in rb.items()},
            {k: torch.from_numpy(v) for k, v in tb.items()})


_PAIRS: dict = {}


def _pair(family):
    """(reference cfg, port cfg, reference params, port params) of a
    family's arch at smoke(), drawn once."""
    if family not in _PAIRS:
        arch = FAMILIES[family]
        rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
        rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
        _PAIRS[family] = (rcfg, cfg, rp, M.params_from_numpy(
            jax.device_get(rp), device="cpu"))
    return _PAIRS[family]


def _ref_value_and_grad(rcfg, rp, rb, **kw):
    return jax.jit(jax.value_and_grad(
        lambda p: ref_tf.loss_fn(p, rb, rcfg, **kw)))(rp)


def _port_value_and_grad(cfg, tp, tb, **kw):
    return tl.value_and_grad(lambda p, b: tf.loss_fn(p, b, cfg, **kw), tp, tb)


# --------------------------------------------------------------------------
# The optimizer
# --------------------------------------------------------------------------


def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 4)).astype(np.float32)},
            "b": rng.standard_normal((7,)).astype(np.float32)}


def test_lr_schedule_matches_reference():
    oc = dict(warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, 3, dtype=np.int32)
    want = [float(ref_opt.lr_at(jnp.int32(s), ref_opt.OptConfig(**oc)))
            for s in steps]
    got = [float(opt.lr_at(torch.tensor(int(s), dtype=torch.int32),
                           opt.OptConfig(**oc))) for s in steps]
    np.testing.assert_allclose(got, want, **OPT_BAND)


def test_global_norm_and_clip_match_reference():
    tree = _opt_tree(1)
    tt = M.params_from_numpy(tree, device="cpu")
    np.testing.assert_allclose(float(opt.global_norm(tt)),
                               float(ref_opt.global_norm(tree)), **OPT_BAND)
    for max_norm in (0.5, 1e3):
        got, n = opt.clip_by_global_norm(tt, max_norm)
        want, rn = ref_opt.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(n), float(rn), **OPT_BAND)
        for k, v in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[k], v, **OPT_BAND)


def test_adamw_three_updates_match_reference():
    params = _opt_tree(2)
    tp = M.params_from_numpy(params, device="cpu")
    ts = opt.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["m"]))
    rs = ref_opt.adamw_init(params)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    for i in range(STEPS):
        grads = _opt_tree(10 + i)
        params, rs, rm = ref_opt.adamw_update(grads, rs, params,
                                              ref_opt.OptConfig(**oc))
        tp, ts, tm = opt.adamw_update(M.params_from_numpy(grads, device="cpu"),
                                      ts, tp, opt.OptConfig(**oc))
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        for k, v in _flat({"p": params, "m": rs["m"], "v": rs["v"]}).items():
            np.testing.assert_allclose(
                _flat({"p": tp, "m": ts["m"], "v": ts["v"]})[k], v,
                err_msg=k, **OPT_BAND)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), **OPT_BAND)


def test_in_place_adamw_is_the_functional_update_bit_for_bit():
    """``adamw_update_`` (the captured step's, one leaf at a time) writes
    exactly what ``adamw_update`` returns."""
    tp = M.params_from_numpy(_opt_tree(5), device="cpu", dtype=torch.bfloat16)
    grads = M.params_from_numpy(_opt_tree(6), device="cpu",
                                dtype=torch.bfloat16)
    oc = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    state = opt.adamw_init(tp)
    want_p, want_s, want_m = tp, state, None
    p = tree_map(torch.clone, tp)
    s = tree_map(torch.clone, state)
    for _ in range(STEPS):
        want_p, want_s, want_m = opt.adamw_update(grads, want_s, want_p, oc)
        got_m = opt.adamw_update_(grads, s, p, oc)
        for a, b in zip(tree_leaves({"p": p, "s": s}),
                        tree_leaves({"p": want_p, "s": want_s})):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for k in ("grad_norm", "lr"):
            assert torch.equal(got_m[k], want_m[k])


def test_adamw_keeps_bfloat16_params_with_float32_moments():
    tp = M.params_from_numpy(_opt_tree(3), device="cpu", dtype=torch.bfloat16)
    ts = opt.adamw_init(tp)
    p2, s2, _ = opt.adamw_update(tp, ts, tp, opt.OptConfig())
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p2))
    assert all(t.dtype == torch.float32 for t in tree_leaves(s2["m"])
               + tree_leaves(s2["v"]))


# --------------------------------------------------------------------------
# build_train_step at smoke(), one arch a family
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_match_jax(family):
    rcfg, cfg, rp, tp = _pair(family)
    rb, tb = _batches(rcfg, cfg, 0)
    rl, rg = _ref_value_and_grad(rcfg, rp, rb)
    tloss, tg = _port_value_and_grad(cfg, tp, tb)
    assert float(tloss) == pytest.approx(float(rl), rel=LOSS_RTOL)
    _trees_close(tg, jax.device_get(rg))
    assert all(bool(g.abs().max() > 0) for g in tree_leaves(tg))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_train_steps_match_reference(family):
    rcfg, cfg, rp, tp = _pair(family)
    rstep = jax.jit(ref_tl.build_train_step(rcfg, ref_opt.OptConfig(**OC)))
    tstep = tl.build_train_step(cfg, opt.OptConfig(**OC))
    ro, to = ref_opt.adamw_init(rp), opt.adamw_init(tp)
    for i in range(STEPS):
        rb, tb = _batches(rcfg, cfg, i)
        r0, t0 = _flat(jax.device_get(rp)), _flat(tp)
        rp, ro, rm = rstep(rp, ro, rb)
        tp, to, tm = tstep(tp, to, tb)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        r1, t1 = _flat(jax.device_get(rp)), _flat(tp)
        for k in r1:
            np.testing.assert_allclose(t1[k], r1[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            dr, dt = r1[k] - r0[k], t1[k] - t0[k]
            assert np.linalg.norm(dt - dr) <= UPDATE_TOL * np.linalg.norm(dr)
        _trees_close({"m": to["m"], "v": to["v"]},
                     {"m": jax.device_get(ro["m"]),
                      "v": jax.device_get(ro["v"])}, prefix=f"step {i} ")
        assert int(to["step"]) == int(ro["step"]) == i + 1


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_accumulated_step_matches_reference(family):
    """``accum=2``: two microbatches of one row, their float32 gradient sum
    halved, against the reference's ``lax.scan`` over the same split."""
    rcfg, cfg, rp, tp = _pair(family)
    rb, tb = _batches(rcfg, cfg, 0)
    ref_p, _, rm = jax.jit(ref_tl.build_train_step(
        rcfg, ref_opt.OptConfig(**OC), accum=2))(
        rp, ref_opt.adamw_init(rp), rb)
    new_p, _, tm = tl.build_train_step(cfg, opt.OptConfig(**OC), accum=2)(
        tp, opt.adamw_init(tp), tb)
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    got = _flat(new_p)
    for k, v in _flat(jax.device_get(ref_p)).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_changes_no_value(family):
    _, cfg, _, tp = _pair(family)
    tb = {k: torch.from_numpy(v)
          for k, v in SyntheticLM(cfg, DataConfig(**DATA)).batch(1).items()}
    l1, g1 = _port_value_and_grad(cfg, tp, tb, remat=True)
    l0, g0 = _port_value_and_grad(cfg, tp, tb, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("switch,family", [
    ("bf16_bwd", "dense"), ("bf16_bwd", "hybrid"),
    ("remat_dots", "dense"), ("remat_dots", "ssm")])
def test_gradient_switches_match_reference(monkeypatch, switch, family):
    """Each switch patched into both packages' module globals (both read
    it at import), the gradients against the reference's."""
    if switch == "bf16_bwd":
        monkeypatch.setattr(ref_layers, "_BF16_BWD", True)
        monkeypatch.setattr(layers, "_BF16_BWD", True)
    else:
        monkeypatch.setattr(ref_tf, "_REMAT_POLICY", "dots")
        monkeypatch.setattr(tf, "_REMAT_POLICY", "dots")
    rcfg, cfg, rp, tp = _pair(family)
    rb, tb = _batches(rcfg, cfg, 2)
    rl, rg = _ref_value_and_grad(rcfg, rp, rb)
    tloss, tg = _port_value_and_grad(cfg, tp, tb)
    assert float(tloss) == pytest.approx(float(rl), rel=LOSS_RTOL)
    _trees_close(tg, jax.device_get(rg))
    if switch == "bf16_bwd":
        x = torch.ones((2, 3), requires_grad=True)
        y = layers.linear({"w": torch.ones((3, 4))}, x)
        assert type(y.grad_fn).__name__ == "DotBf16BwdBackward"


def test_dot_bf16bwd_matches_reference_vjp():
    """``dot_bf16bwd`` of bfloat16 operands: the value and both gradients
    against the reference's custom VJP, within bfloat16's band."""
    rng = np.random.default_rng(4)
    x, w, g = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 8), (8, 6), (3, 5, 6)))
    bf = (lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    y_w, vjp = jax.vjp(ref_layers.dot_bf16bwd, bf(x), bf(w))
    dx_w, dw_w = vjp(bf(g))
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w))
    y = layers.dot_bf16bwd(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw),
                                 torch.from_numpy(g).to(torch.bfloat16))
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    for got, want in ((y, y_w), (dx, dx_w), (dw, dw_w)):
        assert _rel(got.float().detach().numpy(), _flat(want)[""]) <= 2e-2


# --------------------------------------------------------------------------
# The driver: monitors, failure, restart
# --------------------------------------------------------------------------


def test_step_time_monitor_and_heartbeat():
    mon = tl.StepTimeMonitor(k=3.0, alpha=0.5)
    assert [mon.observe(dt) for dt in (1.0, 1.1, 5.0, 1.0, 10.0)] == [
        False, False, True, False, True]
    assert mon.flags == 2
    ref = ref_tl.StepTimeMonitor(k=3.0, alpha=0.5)
    for dt in (1.0, 1.1, 5.0, 1.0, 10.0):
        ref.observe(dt)
    assert mon.mean == ref.mean and mon.flags == ref.flags
    hb = tl.Heartbeat(timeout_s=0.0)
    assert hb.expired()
    hb = tl.Heartbeat(timeout_s=60.0)
    hb.beat()
    assert not hb.expired()


def _batch_fn(cfg):
    source = SyntheticLM(cfg, DataConfig(**DATA))
    return source.batch


def test_resume_after_failure_is_bit_for_bit_an_uninterrupted_run(tmp_path):
    cfg = get_config("recurrentgemma-9b").smoke()
    oc = opt.OptConfig(**OC)
    p_full, o_full, full = tl.train(cfg, steps=6, batch_fn=_batch_fn(cfg),
                                    oc=oc, device="cpu")
    ckpt = Checkpointer(tmp_path / "ck")
    with pytest.raises(tl.SimulatedFailure):
        tl.train(cfg, steps=6, batch_fn=_batch_fn(cfg), oc=oc, device="cpu",
                 checkpointer=ckpt, checkpoint_every=2, fail_at=3)
    ckpt.wait()
    assert ckpt.steps() == [2]
    p, o, rep = tl.resume(cfg, ckpt, steps=6, batch_fn=_batch_fn(cfg), oc=oc,
                          checkpoint_every=2, device="cpu")
    ckpt.wait()
    assert rep.losses == full.losses[2:]
    assert rep.steps_done == 6 and rep.checkpoints == [4, 6]
    for a, b in zip(tree_leaves({"p": p, "o": o}),
                    tree_leaves({"p": p_full, "o": o_full})):
        assert torch.equal(a, b)


def test_train_writes_params_and_state_in_place():
    cfg = get_config("mamba2-780m").smoke()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = opt.adamw_init(params)
    before = [t.clone() for t in tree_leaves(params)]
    p, s, rep = tl.train(cfg, steps=2, batch_fn=_batch_fn(cfg),
                         params=params, opt_state=state, device="cpu")
    assert p is params and s is state and int(state["step"]) == 2
    assert all(not torch.equal(a, b)
               for a, b in zip(tree_leaves(params), before))
    assert len(rep.losses) == rep.steps_done == 2
    assert all(np.isfinite(rep.losses))


def test_the_step_runner_is_the_functional_step_bit_for_bit():
    """``TrainStep`` (bound trees written in place; eager on the CPU)
    takes the functional ``build_train_step``'s step exactly."""
    cfg = get_config("recurrentgemma-9b").smoke()
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    want_p, want_s = params, opt.adamw_init(params)
    p, s = tree_map(torch.clone, want_p), tree_map(torch.clone, want_s)
    runner = tl.TrainStep(cfg, p, s, opt.OptConfig(**OC))
    step = tl.build_train_step(cfg, opt.OptConfig(**OC))
    source = _batch_fn(cfg)
    for i in range(2):
        batch = source(i)
        got = runner(batch)
        want_p, want_s, want = step(want_p, want_s, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert all(torch.equal(got[k], want[k]) for k in tl.TrainStep.OUTPUTS)
    for a, b in zip(tree_leaves({"p": p, "s": s}),
                    tree_leaves({"p": want_p, "s": want_s})):
        assert torch.equal(a, b)


def test_sharded_paths_raise_until_item_7b():
    """Named for when the sharded paths raised; they run now (held against
    the reference in ``tests/test_torch_gspmd.py`` and
    ``tests/test_torch_shard_map.py``).  ``compress_grads`` over
    ``dp_axes`` builds a step whose all-reduce needs ``shard_map``'s named
    axes, as the reference's does; ``jit_train_step`` returns the sharded
    step; ``train(mesh=...)`` with unplaced parameters reads no mesh, as
    the reference's."""
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_config("mamba2-780m").smoke()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = _batch_fn(cfg)(0)
    step = tl.build_train_step(cfg, compress_grads=True, dp_axes=("data",))
    with pytest.raises(NameError, match="unbound axis"):
        step(params, opt.adamw_init(params),
             {k: torch.from_numpy(v) for k, v in batch.items()})
    mesh = make_debug_mesh((2, 1), ("data", "model"), device="cpu")
    sharded = tl.jit_train_step(cfg, mesh, params, batch)
    assert isinstance(sharded, tl.ShardedTrainStep)
    _, _, rep = tl.train(cfg, steps=1, batch_fn=_batch_fn(cfg), mesh=object(),
                         device="cpu")
    assert rep.steps_done == 1 and np.isfinite(rep.losses[0])


# --------------------------------------------------------------------------
# The compiled driver
# --------------------------------------------------------------------------


def _compiled_pair():
    import codo
    import codo_torch
    from repro.models.dataflow_models import gpt2_block_loss_fn as ref_fn
    from repro_torch.models.dataflow_models import gpt2_block_loss_fn
    shape = (32, 64)
    ours = codo_torch.compile(gpt2_block_loss_fn, shape, shape, grad=True,
                              device="cpu", opt=opt.OptConfig(**OC))
    theirs = codo.compile(ref_fn, shape, shape, grad=True,
                          opt=ref_opt.OptConfig(**OC))
    return ours, theirs


def _compiled_batch(i):
    x = np.random.default_rng(100 + i).standard_normal((32, 64)).astype(
        np.float32)
    return x, 0.9 * x


def test_train_compiled_and_resume(tmp_path):
    ours, theirs = _compiled_pair()
    _, _, ref = ref_tl.train_compiled(theirs, steps=5,
                                      batch_fn=_compiled_batch)
    _, _, full = tl.train_compiled(ours, steps=5, batch_fn=_compiled_batch)
    np.testing.assert_allclose(full.losses, ref.losses, rtol=1e-5)
    ckpt = Checkpointer(tmp_path / "ck")
    with pytest.raises(tl.SimulatedFailure):
        tl.train_compiled(ours, steps=5, batch_fn=_compiled_batch,
                          checkpointer=ckpt, checkpoint_every=2, fail_at=3,
                          verify_every=2)
    ckpt.wait()
    _, _, rep = tl.resume_compiled(ours, ckpt, steps=5,
                                   batch_fn=_compiled_batch)
    assert rep.losses == full.losses[2:]


# --------------------------------------------------------------------------
# The CLI and its deprecated alias
# --------------------------------------------------------------------------


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def test_cli_arch_path_fails_at_and_resumes(tmp_path):
    common = ["--arch", "mamba2-780m", "--smoke", "--steps", "4", "--batch",
              "2", "--seq", "32", "--device", "cpu"]
    rc, text = _cli(*common)
    assert rc == 0 and "arch=mamba2-780m-smoke steps=4" in text
    ck = str(tmp_path / "ck")
    rc, text = _cli(*common, "--ckpt", ck, "--ckpt-every", "2",
                    "--fail-at", "3")
    assert rc == 42 and "injected failure at step 3" in text
    rc, text = _cli(*common, "--ckpt", ck, "--ckpt-every", "2", "--resume")
    assert rc == 0 and "steps=4" in text and "checkpoints at [4]" in text


def test_cli_compiled_path(tmp_path):
    rc, text = _cli("--compiled", "--steps", "3", "--seq", "32",
                    "--d-model", "64", "--device", "cpu")
    assert rc == 0 and text.startswith("compiled train step: steps=3")
    ck = str(tmp_path / "ck")
    rc, text = _cli("--compiled", "--steps", "3", "--seq", "32", "--d-model",
                    "64", "--device", "cpu", "--ckpt", ck, "--ckpt-every",
                    "1", "--fail-at", "2")
    assert rc == 42


def test_cli_overrides_and_flags_match_reference():
    from repro.training import cli as ref_cli
    import argparse

    def flags(module):
        seen = []
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            seen.extend(a.dest for a in self._actions)
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                module.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return set(seen)

    assert flags(cli) == flags(ref_cli) | {"device"}


def test_launch_train_is_a_deprecated_alias():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        module = importlib.reload(importlib.import_module(
            "repro_torch.launch.train"))
    assert module.main is cli.main
