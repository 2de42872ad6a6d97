"""The port's sharded train step on a mesh (``jit_train_step``,
``train(mesh=...)``, ``resume(shardings=...)``, ``Checkpointer.restore(
shardings=...)``) against the JAX reference, on the CPU.

The port runs on a 4 x 2 ``("data", "model")`` mesh of eight CPU
positions (``make_debug_mesh(device="cpu")``); the reference runs its own
``jit_train_step`` on a 1 x 1 ``jax.sharding.Mesh`` of the one CPU device
under ``use_mesh``, which GSPMD promises is the unsharded step.  Both
start from the reference's parameters (``params_from_numpy``) and the same
``SyntheticLM`` batches of 8 rows (two a data position), at ``smoke()``,
for gpt2-medium, mamba2-780m, recurrentgemma-9b and mixtral-8x22b; the
loss every step, and after three steps the gathered parameters, m and v,
are held to the bands ``tests/test_torch_training.py`` holds the
unsharded step to.  After each step every position holds exactly the
local shard its spec gives, in the very tensors it held before (the
state is donated).  mixtral's eight batch rows are 256 tokens, one MoE
dispatch chunk, so its four data blocks are computed together; with
``REPRO_MOE_CHUNK`` at 64 (patched in both packages) each block is its
own chunk and is computed alone.

Then the training loop: ``train(mesh=...)`` with unplaced parameters is
``train()`` bit for bit (the reference reads no ``mesh`` either), and
with parameters placed on the mesh runs the sharded step within the same
bands; a checkpoint saved on 4 x 2 restores onto 2 x 2 bit for bit; and
``resume(shardings=...)`` onto 2 x 2 after a failure on 4 x 2 continues
within the bands of the uninterrupted run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.distributed.sharding import use_mesh as ref_use_mesh  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_tl  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (PlacedArray, gather,  # noqa: E402
                                              place)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

ARCHS = ("gpt2-medium", "mamba2-780m", "recurrentgemma-9b", "mixtral-8x22b")
LOSS_RTOL = 1e-6
GRAD_BAND = 1e-5             # of each leaf's largest value
PARAM_ATOL = 5e-5
UPDATE_TOL = 1e-2
DATA = dict(seq_len=32, global_batch=8, seed=0, mean_doc_len=16)
OC = dict(warmup_steps=2, total_steps=10)
STEPS = 3


def _mesh(shape=(4, 2)):
    return make_debug_mesh(shape, ("data", "model"), device="cpu")


def _ref_mesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _flat(tree, pre=""):
    """{path: float32 / int numpy} of a nest of dicts of jax arrays,
    tensors or placed arrays (gathered)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, PlacedArray):
        tree = tree.gather()
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


_PAIRS: dict = {}


def _pair(arch):
    """(reference cfg, port cfg, reference params as numpy) at smoke()."""
    if arch not in _PAIRS:
        rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
        rp = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(0)))
        _PAIRS[arch] = (rcfg, cfg, rp)
    return _PAIRS[arch]


def _batch(cfg, step, data=DATA):
    return SyntheticLM(cfg, DataConfig(**data)).batch(step)


def _shards_as_specs(tree):
    """Every position's shard has the local shape its spec gives."""
    for a in tree_leaves(tree):
        want = a.sharding.shard_shape(a.shape)
        for p, s in enumerate(a.shards):
            assert tuple(s.shape) == want, (a.sharding.spec, p)
            assert torch.equal(s, a.sharding.local(a.gather(), p))


def _ptrs(tree):
    return [s.data_ptr() for a in tree_leaves(tree) for s in a.shards]


def _three_steps(arch):
    """The reference's and the port's three sharded steps from the same
    state: (losses both ways, final states both ways, the steps'
    parameters before and after, placed trees)."""
    rcfg, cfg, rp_np = _pair(arch)
    rmesh, mesh = _ref_mesh(), _mesh()
    rp = jax.tree.map(jax.numpy.asarray, rp_np)
    ro = ref_opt.adamw_init(rp)
    tp = M.params_from_numpy(rp_np, device="cpu")
    to = opt.adamw_init(tp)
    rstep = ref_tl.jit_train_step(rcfg, rmesh, rp, _batch(cfg, 0),
                                  ref_opt.OptConfig(**OC))
    tstep = tl.jit_train_step(cfg, mesh, tp, _batch(cfg, 0),
                              opt.OptConfig(**OC))
    losses, updates = [], []
    placed = None
    for i in range(STEPS):
        b = _batch(cfg, i)
        assert all(np.array_equal(b[k], v) for k, v in RefSyntheticLM(
            rcfg, RefDataConfig(**DATA)).batch(i).items())
        r0 = _flat(jax.device_get(rp))
        t0 = _flat(tp)
        with ref_use_mesh(rmesh):
            rp, ro, rm = rstep(rp, ro, {k: jax.numpy.asarray(v)
                                        for k, v in b.items()})
        ptrs = _ptrs({"p": tp, "m": to["m"]}) if placed else None
        tp, to, tm = tstep(tp, to, b)
        if ptrs is not None:
            assert _ptrs({"p": tp, "m": to["m"]}) == ptrs   # in place
        placed = True
        losses.append((float(tm["loss"]), float(rm["loss"])))
        updates.append((r0, _flat(jax.device_get(rp)), t0, _flat(tp)))
    return losses, updates, (rp, ro), (tp, to)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_reference(arch):
    losses, updates, (rp, ro), (tp, to) = _three_steps(arch)
    for got, want in losses:
        assert got == pytest.approx(want, rel=LOSS_RTOL)
    for r0, r1, t0, t1 in updates:
        for k in r1:
            np.testing.assert_allclose(t1[k], r1[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            dr, dt = r1[k] - r0[k], t1[k] - t0[k]
            assert np.linalg.norm(dt - dr) <= UPDATE_TOL * np.linalg.norm(dr)
    got = _flat({"m": to["m"], "v": to["v"]})
    for k, v in _flat({"m": jax.device_get(ro["m"]),
                       "v": jax.device_get(ro["v"])}).items():
        assert _rel(got[k], v) <= GRAD_BAND, k
    assert int(to["step"].gather()) == int(ro["step"]) == STEPS
    _shards_as_specs({"p": tp, "o": to})
    # FSDP over data and TP over model: the embedding's eight shards
    emb = tp["embed"]["tok"]
    assert emb.sharding.spec == ("model", "data")
    assert len({tuple(s.shape) for s in emb.shards}) == 1
    assert emb.shards[0].numel() * 8 == emb.gather().numel()


def test_moe_blocks_follow_the_dispatch_chunk(monkeypatch):
    """A MoE step's data blocks are computed together while their tokens
    share a dispatch chunk (``compute_blocks``), so the capacity drops are
    the reference's: with REPRO_MOE_CHUNK=64 each 64-token block is its
    own chunk, and the sharded step still matches the reference's."""
    assert spmd.compute_blocks(8, 4, 32, 1024) == [(0, 8)]
    assert spmd.compute_blocks(8, 4, 32, 64) == [(0, 2), (2, 4), (4, 6),
                                                  (6, 8)]
    assert spmd.compute_blocks(8, 4, 32, 128) == [(0, 4), (4, 8)]
    assert spmd.compute_blocks(8, 4, 32, None) == [(0, 2), (2, 4), (4, 6),
                                                    (6, 8)]
    assert spmd.compute_blocks(6, 4, 32, None) == [(0, 6)]
    monkeypatch.setattr(ref_layers, "_MOE_CHUNK", 64)
    monkeypatch.setattr(layers, "_MOE_CHUNK", 64)
    rcfg, cfg, rp_np = _pair("mixtral-8x22b")
    b = _batch(cfg, 0)
    rp = jax.tree.map(jax.numpy.asarray, rp_np)
    rstep = ref_tl.jit_train_step(rcfg, _ref_mesh(), rp, b,
                                  ref_opt.OptConfig(**OC))
    with ref_use_mesh(_ref_mesh()):
        _, _, rm = rstep(rp, ref_opt.adamw_init(rp),
                         {k: jax.numpy.asarray(v) for k, v in b.items()})
    tp = M.params_from_numpy(rp_np, device="cpu")
    _, _, tm = tl.jit_train_step(cfg, _mesh(), tp, b, opt.OptConfig(**OC))(
        tp, opt.adamw_init(tp), b)
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k


def test_one_data_block_is_the_unsharded_step_bit_for_bit():
    """On a mesh of one position (1 x 1) the sharded step — placement,
    units, the block reduction and the update of every shard — is the
    unsharded ``build_train_step`` bit for bit: the same gradient, norm and
    update.  (With two model positions the split sums in another order:
    ``test_one_data_block_over_two_model_positions_matches_reference``.)"""
    _, cfg, rp_np = _pair("recurrentgemma-9b")
    tp = M.params_from_numpy(rp_np, device="cpu")
    want_p, want_s = tree_map(torch.clone, tp), opt.adamw_init(tp)
    step = tl.jit_train_step(cfg, _mesh((1, 1)), tp, _batch(cfg, 0),
                             opt.OptConfig(**OC))
    plain = tl.build_train_step(cfg, opt.OptConfig(**OC))
    p, s = tp, opt.adamw_init(tp)
    for i in range(2):
        b = _batch(cfg, i)
        p, s, m = step(p, s, b)
        want_p, want_s, wm = plain(want_p, want_s,
                                   {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert all(torch.equal(m[k], wm[k]) for k in tl.TrainStep.OUTPUTS)
    for a, b in zip(tree_leaves(gather({"p": p, "s": s})),
                    tree_leaves({"p": want_p, "s": want_s})):
        assert torch.equal(a, b)


def test_one_data_block_over_two_model_positions_matches_reference():
    """One data block over two model positions (1 x 2): the heads, channels
    and vocab split over ``model``, held to the reference's step within
    the bands of ``test_sharded_train_steps_match_reference``."""
    rcfg, cfg, rp_np = _pair("recurrentgemma-9b")
    rp = jax.tree.map(jax.numpy.asarray, rp_np)
    ro = ref_opt.adamw_init(rp)
    rstep = ref_tl.jit_train_step(rcfg, _ref_mesh(), rp, _batch(cfg, 0),
                                  ref_opt.OptConfig(**OC))
    tp = M.params_from_numpy(rp_np, device="cpu")
    to = opt.adamw_init(tp)
    step = tl.jit_train_step(cfg, _mesh((1, 2)), tp, _batch(cfg, 0),
                             opt.OptConfig(**OC))
    for i in range(2):
        b = _batch(cfg, i)
        with ref_use_mesh(_ref_mesh()):
            rp, ro, rm = rstep(rp, ro, {k: jax.numpy.asarray(v)
                                        for k, v in b.items()})
        tp, to, tm = step(tp, to, b)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
    got = _flat(tp)
    for k, v in _flat(jax.device_get(rp)).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    got = _flat({"m": to["m"], "v": to["v"]})
    for k, v in _flat({"m": jax.device_get(ro["m"]),
                       "v": jax.device_get(ro["v"])}).items():
        assert _rel(got[k], v) <= GRAD_BAND, k


def test_accumulated_sharded_step_matches_reference():
    """``accum=2`` on the mesh against the reference's ``accum=2``: each
    microbatch split over the data positions, the loss the mean of the
    microbatches' token-weighted means."""
    rcfg, cfg, rp_np = _pair("mamba2-780m")
    b = _batch(cfg, 1)
    rp = jax.tree.map(jax.numpy.asarray, rp_np)
    rstep = ref_tl.jit_train_step(rcfg, _ref_mesh(), rp, b,
                                  ref_opt.OptConfig(**OC), accum=2)
    with ref_use_mesh(_ref_mesh()):
        rp2, _, rm = rstep(rp, ref_opt.adamw_init(rp),
                           {k: jax.numpy.asarray(v) for k, v in b.items()})
    tp = M.params_from_numpy(rp_np, device="cpu")
    tp2, _, tm = tl.jit_train_step(cfg, _mesh(), tp, b, opt.OptConfig(**OC),
                                   accum=2)(tp, opt.adamw_init(tp), b)
    for k in ("loss", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    got = _flat(tp2)
    for k, v in _flat(jax.device_get(rp2)).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_undonated_step_leaves_its_inputs():
    _, cfg, rp_np = _pair("mamba2-780m")
    mesh = _mesh()
    tp = M.params_from_numpy(rp_np, device="cpu")
    spec = tl.train_state_shardings(tp, mesh, cfg)
    p = place(tp, spec["params"])
    s = place(opt.adamw_init(tp), spec["opt"])
    before = _flat({"p": p, "s": s})
    step = tl.jit_train_step(cfg, mesh, tp, _batch(cfg, 0),
                             opt.OptConfig(**OC), donate=False)
    p2, s2, _ = step(p, s, _batch(cfg, 0))
    assert _flat({"p": p, "s": s}).keys() == before.keys()
    assert all(np.array_equal(v, _flat({"p": p, "s": s})[k])
               for k, v in before.items())
    assert int(s2["step"].gather()) == 1 and p2 is not p


def test_jit_on_a_mesh_over_several_cards_raises_naming_item_10():
    """Capturing a lockstep step whose positions sit on several cards is
    not ported: ``jit=True`` raises naming its ROADMAP.md item (a mesh of
    card devices needs no card to build), as ``lower`` does."""
    import re
    from pathlib import Path

    from repro_torch.core.capture import CaptureError
    from repro_torch.distributed.plan import MeshSpec
    from repro_torch.launch.mesh import Mesh
    spec = MeshSpec((("data", 4), ("model", 2)))
    cards = Mesh(spec, [torch.device("cuda", i) for i in range(8)])
    step = spmd.LockstepStep(cards, "train_step", dict, [], jit=True)
    with pytest.raises(CaptureError) as err:
        step({})
    m = re.search(r"Queue 1 item (\d+) \(([\w-]+) ", str(err.value))
    queue = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    queue = queue.split("### Queue 1")[1].split("### Queue 2")[0]
    item = re.search(rf"^{m.group(1)}\. \*\*(.+?)\*\*", queue, re.M)
    assert item and item.group(1).startswith(m.group(2)), item
    assert spmd.LockstepStep(cards, "eager", dict, [], jit=False)({}) == {}


def _batch_fn(cfg):
    source = SyntheticLM(cfg, DataConfig(**DATA))
    return source.batch


def test_train_on_a_mesh():
    """``train(mesh=...)``: unplaced parameters train as ``train()`` does,
    bit for bit; parameters placed on the mesh train sharded, within the
    bands, their shards written in place and checkpointed gathered."""
    _, cfg, rp_np = _pair("mamba2-780m")
    mesh = _mesh()
    oc = opt.OptConfig(**OC)
    fn = _batch_fn(cfg)
    p_a = M.params_from_numpy(rp_np, device="cpu")
    p_b = M.params_from_numpy(rp_np, device="cpu")
    _, s_a, r_a = tl.train(cfg, steps=2, batch_fn=fn, params=p_a, oc=oc,
                           device="cpu")
    _, s_b, r_b = tl.train(cfg, steps=2, batch_fn=fn, params=p_b, oc=oc,
                           mesh=mesh, device="cpu")
    assert r_a.losses == r_b.losses
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": p_a, "s": s_a}), tree_leaves({"p": p_b, "s": s_b})))
    placed = place(M.params_from_numpy(rp_np, device="cpu"),
                   tl.train_state_shardings(p_a, mesh, cfg)["params"])
    ptrs = _ptrs(placed)
    p_c, s_c, r_c = tl.train(cfg, steps=2, batch_fn=fn, params=placed,
                             oc=oc, mesh=mesh)
    assert p_c is placed and _ptrs(p_c) == ptrs
    assert isinstance(s_c["m"]["embed"]["tok"], PlacedArray)
    for got, want in zip(r_c.losses, r_a.losses):
        assert got == pytest.approx(want, rel=LOSS_RTOL)
    want = _flat(p_a)
    for k, v in _flat(p_c).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_save_on_4x2_restores_onto_2x2_bit_for_bit(tmp_path):
    _, cfg, rp_np = _pair("recurrentgemma-9b")
    tp = M.params_from_numpy(rp_np, device="cpu")
    state = {"params": tp, "opt": opt.adamw_init(tp)}
    state["opt"]["m"] = tree_map(lambda t: torch.randn_like(t.float()),
                                 state["opt"]["m"])
    big, small = _mesh((4, 2)), _mesh((2, 2))
    placed = place(state, tl.train_state_shardings(tp, big, cfg))
    ck = Checkpointer(tmp_path)
    ck.save(5, placed, blocking=True)
    like = tree_map(torch.zeros_like, state)
    shardings = tl.train_state_shardings(tp, small, cfg)
    step, back = ck.restore_latest(like, shardings)
    assert step == 5
    for a in tree_leaves(back):
        assert isinstance(a, PlacedArray) and a.sharding.mesh is small
    _shards_as_specs(back)
    got, want = _flat(back), _flat(state)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert tree_leaves(back["params"])[0].dtype == tree_leaves(tp)[0].dtype


def test_elastic_resume_onto_a_smaller_mesh(tmp_path):
    """Train on 4 x 2 with a checkpoint every step and a failure after
    step 2; ``resume(shardings=...)`` onto 2 x 2 continues to step 4 within
    the bands of an uninterrupted run on 4 x 2."""
    _, cfg, rp_np = _pair("mamba2-780m")
    oc = opt.OptConfig(**OC)
    fn = _batch_fn(cfg)
    big, small = _mesh((4, 2)), _mesh((2, 2))
    spec = tl.train_state_shardings(M.params_from_numpy(rp_np, device="cpu"),
                                    big, cfg)
    _, _, whole = tl.train(cfg, steps=4, batch_fn=fn, oc=oc, params=place(
        M.params_from_numpy(rp_np, device="cpu"), spec["params"]))
    ck = Checkpointer(tmp_path)
    with pytest.raises(tl.SimulatedFailure):
        tl.train(cfg, steps=4, batch_fn=fn, oc=oc, checkpointer=ck,
                 checkpoint_every=1, fail_at=2, params=place(
                     M.params_from_numpy(rp_np, device="cpu"),
                     spec["params"]))
    ck.wait()
    shardings = tl.train_state_shardings(
        M.params_from_numpy(rp_np, device="cpu"), small, cfg)
    p, s, rep = tl.resume(cfg, ck, steps=4, batch_fn=fn, oc=oc,
                          shardings=shardings, device="cpu")
    assert tree_leaves(p)[0].sharding.mesh is small
    assert int(s["step"].gather()) == 4 and rep.steps_done == 4
    for got, want in zip(rep.losses, whole.losses[2:]):
        assert got == pytest.approx(want, rel=LOSS_RTOL)
