"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
reference's, on the CPU: the same layout, key paths, file names and
checksums; round trips (bfloat16 exact), ``keep`` GC, torn and corrupt
checkpoints skipped; and checkpoints crossing both ways — one written by
the reference's ``train`` restores in the port with equal leaves, one
written by the port's ``train`` restores in the reference with equal
leaves."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.checkpoint import checkpointer as ref_ck  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_loop as ref_tl  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

DATA = dict(seq_len=32, global_batch=2, seed=0, mean_doc_len=16)
ARCH = "mamba2-780m"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 3), generator=g),
                       "blk": {"b": torch.randn((5,), generator=g).to(
                           torch.bfloat16)}},
            "opt": {"m": {"w": torch.randn((4, 3), generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _like(tree):
    return tree_map(torch.zeros_like, tree)


def _np(tree):
    return tree_map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16
                    else t.numpy(), tree)


def test_round_trip_keeps_values_dtypes_and_layout(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path)
    ck.save(3, tree, blocking=True)
    assert ck.steps() == [3]
    step, back = ck.restore_latest(_like(tree))
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(_np(tree)))
    # the reference's key paths, file names and checksums for the same tree
    ref_flat = ref_ck._flatten(_np(tree))
    assert [e["key"] for e in manifest["leaves"]] == [k for k, _ in ref_flat]
    for entry, (_, arr) in zip(manifest["leaves"], ref_flat):
        assert (tmp_path / "step_3" / entry["file"]).exists()
        assert entry["shape"] == list(arr.shape)
    _, raw = ck.restore_latest()
    assert raw["params/blk/b"].dtype == np.float32    # bfloat16 as float32


def test_keep_collects_old_steps_and_torn_or_corrupt_ones_are_skipped(
        tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    ck.wait()
    assert ck.steps() == [3, 4]
    (tmp_path / "step_9").mkdir()                   # torn: no manifest
    assert ck.steps() == [3, 4]
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    np.save(tmp_path / "step_4" / manifest["leaves"][0]["file"],
            np.zeros((4, 3), np.float32))          # corrupt the newest
    step, back = ck.restore_latest(_like(_tree()))
    assert step == 3
    assert torch.equal(back["params"]["w"], _tree(3)["params"]["w"])
    # restore onto a mesh: each leaf placed by its sharding, whole again
    # when gathered (tests/test_torch_gspmd.py: 4 x 2 onto 2 x 2)
    from repro_torch.distributed.sharding import (P, NamedSharding,
                                                  PlacedArray, replicated)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh((2,), ("data",), device="cpu")
    sh = tree_map(lambda t: replicated(mesh), _tree())
    sh["params"]["w"] = NamedSharding(mesh, P("data"))
    placed = ck.restore(3, _like(_tree()), shardings=sh)
    w = placed["params"]["w"]
    assert isinstance(w, PlacedArray) and [tuple(s.shape)
                                           for s in w.shards] == [(2, 3)] * 2
    assert torch.equal(w.gather(), _tree(3)["params"]["w"])
    b = placed["params"]["blk"]["b"]
    assert b.dtype == torch.bfloat16 and torch.equal(
        b.gather(), _tree(3)["params"]["blk"]["b"])


def test_reference_bfloat16_leaves_restore_by_their_bits(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((6,)).astype(np.float32)
    ref = ref_ck.Checkpointer(tmp_path)
    ref.save(1, {"p": jnp.asarray(vals).astype(jnp.bfloat16)}, blocking=True)
    _, back = Checkpointer(tmp_path).restore_latest(
        {"p": torch.zeros(6, dtype=torch.bfloat16)})
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert back["p"].dtype == torch.bfloat16 and torch.equal(back["p"], want)


def test_reference_train_checkpoint_restores_in_the_port(tmp_path):
    rcfg = ref_get_config(ARCH).smoke()
    source = RefSyntheticLM(rcfg, RefDataConfig(**DATA))
    ck = ref_ck.Checkpointer(tmp_path)
    rp, ro, _ = ref_tl.train(
        rcfg, steps=2, batch_fn=lambda s: {k: jnp.asarray(v) for k, v in
                                           source.batch(s).items()},
        checkpointer=ck, checkpoint_every=2,
        oc=ref_opt.OptConfig(warmup_steps=2, total_steps=4))
    ck.wait()
    cfg = get_config(ARCH).smoke()
    step, state = Checkpointer(tmp_path).restore_latest(
        tl._like(cfg, "cpu"))
    assert step == 2
    want = {"params": jax.device_get(rp), "opt": jax.device_get(ro)}
    got = tree_map(lambda t: t.numpy(), state)
    assert int(got["opt"]["step"]) == 2
    flat_w = dict(ref_ck._flatten(want))
    flat_g = dict(ref_ck._flatten(got))
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)
    # and the port trains on from it
    p, o, rep = tl.train(cfg, steps=3, start_step=2, params=state["params"],
                         opt_state=state["opt"], device="cpu",
                         batch_fn=SyntheticLM(cfg, DataConfig(**DATA)).batch)
    assert rep.steps_done == 3 and np.isfinite(rep.losses).all()


def test_port_train_checkpoint_restores_in_the_reference(tmp_path):
    cfg = get_config(ARCH).smoke()
    ck = Checkpointer(tmp_path)
    p, o, _ = tl.train(cfg, steps=2, device="cpu", checkpointer=ck,
                       checkpoint_every=2,
                       batch_fn=SyntheticLM(cfg, DataConfig(**DATA)).batch,
                       oc=opt.OptConfig(warmup_steps=2, total_steps=4))
    ck.wait()
    rcfg = ref_get_config(ARCH).smoke()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(1))
    like = {"params": rp, "opt": ref_opt.adamw_init(rp)}
    step, state = ref_ck.Checkpointer(tmp_path).restore_latest(like)
    assert step == 2
    got = dict(ref_ck._flatten(jax.device_get(state)))
    want = dict(ref_ck._flatten(tree_map(lambda t: t.numpy(),
                                         {"params": p, "opt": o})))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
