"""A mesh split over ranks, one process a card, on the CPU (gloo).

``repro_torch.launch.ranks.spawn`` starts the ranks (``spawn`` start
method, a ``FileStore`` rendezvous, gloo because the ranks run on the
CPU); inside them ``rank_mesh`` deals a 4 x 2 ``("data", "model")`` mesh
to 2 or 4 ranks.  Every rank's result is held bit for bit against the
single-process lockstep run on the same mesh (``make_debug_mesh(device=
"cpu")``, eight positions in one process), which ``test_torch_gspmd.py``
holds against the reference:

* the launcher: a rank's exception comes back to the parent with its
  traceback, and a rank that sleeps past a 5 s limit is killed and
  reported;
* every ``make_collective`` form (direct psum, reduce-scatter +
  all-gather, direct and ring all-gather along dims 0 and 1) and
  ``group_psum`` / ``group_pmax`` / ``group_all_gather`` along both axes,
  on seeded values, and ``PlacedArray.gather`` of a leaf split over both;
* the slice: ``jit_train_step`` at ``smoke()`` for mamba2-780m and
  gpt2-medium, two steps: the loss every step, and the gathered
  parameters, m and v; one case also against the reference's own
  ``jit_train_step`` (run in this process on a 1 x 1 ``jax.sharding.
  Mesh``, which GSPMD promises is the unsharded step) within
  ``tests/test_torch_gspmd.py``'s bands;
* the gpt2_block program through ``codo_torch.compile(mesh=rank_mesh)``
  (``lower(sharding=...)``) over 4 ranks, with the plan's vias as chosen
  and forced to the ring and reduce-scatter + all-gather: its output.

The ranks import nothing of JAX (each checks).  Every spawn runs under its
own time limit, so a hang fails in seconds.
"""

import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import ranks  # noqa: E402

SHAPE, AXES = (4, 2), ("data", "model")
OC = dict(warmup_steps=2, total_steps=10)
DATA = dict(seq_len=32, global_batch=8, seed=0, mean_doc_len=16)
STEPS = 2
LIMIT_S = 90.0
SEED = 0


def _spawn(fn, world, *args, timeout_s=LIMIT_S):
    return ranks.spawn(fn, world, *args, device="cpu", timeout_s=timeout_s)


def _mesh(world):
    """The 4 x 2 rank mesh, the rank computing on one thread (four ranks
    and a test runner share the host's cores)."""
    from repro_torch.distributed.plan import MeshSpec
    from repro_torch.launch.mesh import rank_mesh
    torch.set_num_threads(1)
    mesh = rank_mesh(MeshSpec(tuple(zip(AXES, SHAPE))), device="cpu")
    assert mesh.world == world and "jax" not in sys.modules
    return mesh


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def _fails_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def _sleeps_on_rank_zero(rank, world):
    if rank == 0:
        time.sleep(120)
    return rank


def _dealt(rank, world):
    from repro_torch.core.lowering import place_sharding
    from repro_torch.launch.mesh import mesh_from_spec
    mesh = _mesh(world)
    # a pure-data mesh meets devices as the process group's rank mesh
    spec = mesh.spec
    placed = [mesh_from_spec(spec),
              place_sharding(type("Plan", (), {"mesh": spec})(),
                             device="cpu")]
    assert all(m.distributed and m.ranks == mesh.ranks
               and m.local_positions == mesh.local_positions
               for m in placed)
    return mesh.ranks, mesh.local_positions, sorted(mesh.rank_groups)


def test_spawn_deals_the_mesh_and_returns_in_rank_order():
    got = _spawn(_dealt, 4)
    for rank, (dealt, local, groups) in enumerate(got):
        assert dealt == (0, 0, 1, 1, 2, 2, 3, 3)
        assert local == (2 * rank, 2 * rank + 1)
        assert groups == [(0, 1, 2, 3)]         # data spans every rank


def test_a_ranks_exception_reaches_the_parent_with_its_traceback():
    with pytest.raises(ranks.RankError) as err:
        _spawn(_fails_on_rank_one, 2)
    assert "rank 1 of 2 raised" in str(err.value)
    assert "ValueError: rank one fails on purpose" in str(err.value)
    assert "Traceback" in str(err.value)


def test_a_rank_past_its_limit_is_killed_and_reported():
    t0 = time.monotonic()
    # rank 1 may still be starting on a loaded host: it is reported too
    with pytest.raises(ranks.RankTimeout, match=r"ranks \[0(, 1)?\] of 2"):
        _spawn(_sleeps_on_rank_zero, 2, timeout_s=5.0)
    assert time.monotonic() - t0 < 30.0


def _where_dealt(rank, world):
    """The devices rank_mesh gives by default: spawn's CPU here; the card
    where spawn put the rank on the card, whatever the backend (gloo
    here); and, in a process group spawn did not start, the card, which
    this host lacks."""
    import torch.distributed as dist

    from repro_torch.distributed.plan import MeshSpec
    from repro_torch.launch.mesh import rank_mesh
    spec = MeshSpec(tuple(zip(AXES, SHAPE)))
    assert dist.get_backend() == "gloo"
    out = {"spawn_cpu": {str(d) for d in rank_mesh(spec).devices}}
    ranks._DEVICE = torch.device("cuda", rank)   # as spawn sets it on a card
    out["spawn_card"] = {str(d) for d in rank_mesh(spec).devices}
    ranks._DEVICE = None
    try:
        rank_mesh(spec)
        out["no_spawn"] = "dealt"
    except RuntimeError as err:
        out["no_spawn"] = str(err)
    return out


def test_rank_mesh_lies_where_spawn_put_the_rank():
    for got in _spawn(_where_dealt, 2):
        assert got["spawn_cpu"] == {"cpu"}
        assert got["spawn_card"] == {"cuda:0", "cuda:1"}
        assert "none is available" in got["no_spawn"]


def test_no_fallback_from_nccl_to_gloo():
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        ranks.spawn(_dealt, 2, device="cpu", backend="nccl")


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------


def _collectives(rank, world):
    """Every rank form against the single-process form on the same
    seeded values; the names of the cases that differ."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.plan import CollectiveStep
    from repro_torch.distributed.sharding import NamedSharding, P, place
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = _mesh(world)
    single = make_debug_mesh(SHAPE, AXES, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    xs = [torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
          for _ in range(mesh.size)]
    bf = [x.to(torch.bfloat16) for x in xs]
    bad, cases = [], 0
    forms = [("psum", "direct", 0), ("psum", "rs_ag", 0),
             ("all_gather", "direct", 0), ("all_gather", "direct", 1),
             ("all_gather", "ring", 0), ("all_gather", "ring", 1)]
    for axis in AXES:
        for kind, via, dim in forms:
            step = CollectiveStep(kind=kind, buffer="b", axis=axis, task="t",
                                  dim=dim, via=via)
            one = coll.make_collective(step, single)
            across = coll.make_collective(step, mesh)
            for group in mesh.groups(axis):
                here = [p for p in group if mesh.is_local(p)]
                if not here:            # another rank's group
                    continue
                want = one([xs[p] for p in group])
                got = across([xs[p] for p in here], group)
                for p, g in zip(here, got):
                    cases += 1
                    if not torch.equal(g, want[group.index(p)]):
                        bad.append(f"{kind}/{via}/{dim} over {axis} at {p}")
        for name, fn in (("group_psum", coll.group_psum),
                         ("group_pmax", coll.group_pmax),
                         ("group_all_gather",
                          lambda v, **kw: coll.group_all_gather(v, 1, **kw))):
            for values in (xs, bf):
                for group in mesh.groups(axis):
                    if not any(mesh.is_local(p) for p in group):
                        continue
                    want = fn([values[p] for p in group])
                    got = fn([values[p] for p in group if mesh.is_local(p)],
                             group=group, mesh=mesh)
                    cases += 1
                    if not (got.dtype == want.dtype
                            and torch.equal(got, want)):
                        bad.append(f"{name} {values[0].dtype} over {axis} "
                                   f"{group}")
    whole = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    for spec in (P("data", "model"), P("model", None), P(None, "data"), P()):
        placed = place(whole, NamedSharding(mesh, spec))
        assert set(placed.local_shards()) == set(mesh.local_positions)
        cases += 1
        if not torch.equal(placed.gather(), whole):
            bad.append(f"gather {spec}")
    return cases, bad


@pytest.mark.parametrize("world", [1, 2, 4])
def test_every_collective_form_across_ranks_is_the_single_process_form(
        world):
    for cases, bad in _spawn(_collectives, world):
        assert cases > 0 and bad == []


# --------------------------------------------------------------------------
# the slice: the sharded train step over ranks
# --------------------------------------------------------------------------


def _flat(tree, pre=""):
    from repro_torch.distributed.sharding import PlacedArray
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, PlacedArray):
        tree = tree.gather()
    return {pre: tree.detach()}


def _train(mesh, cfg, p0, steps):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    source = SyntheticLM(cfg, DataConfig(**DATA))
    params = tree_map(torch.clone, p0)
    state = opt.adamw_init(params)
    step = tl.jit_train_step(cfg, mesh, params, source.batch(0),
                             opt.OptConfig(**OC))
    losses = []
    for i in range(steps):
        params, state, metrics = step(params, state, source.batch(i))
        losses.append(float(metrics["loss"]))
    return losses, _flat({"params": params, "m": state["m"],
                          "v": state["v"]})


def _digest(tensors: dict) -> str:
    import hashlib
    h = hashlib.sha1()
    for k, v in tensors.items():
        h.update(k.encode() + v.contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _train_ranks(rank, world, arch, ref_params):
    """Two steps over the rank mesh, then on rank 0 the same two steps on
    the single-process mesh: the rank run's losses and a digest of its
    gathered state (every rank's), and rank 0's single-process losses,
    the names of the leaves that differ and (for the reference case) the
    rank run's gathered state as numpy."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = get_config(arch).smoke()
    if ref_params is None:
        p0 = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    else:
        p0 = M.params_from_numpy(ref_params, device="cpu")
    losses, got = _train(_mesh(world), cfg, p0, STEPS)
    out = {"losses": losses, "digest": _digest(got)}
    if rank == 0:
        out["want"], want = _train(make_debug_mesh(SHAPE, AXES,
                                                   device="cpu"),
                                   cfg, p0, STEPS)
        out["differ"] = [k for k in want if not torch.equal(got[k],
                                                             want[k])]
        if ref_params is not None:
            out["state"] = {k: (v.float() if v.is_floating_point() else v)
                            .numpy() for k, v in got.items()}
    return out


def _agree(runs: list) -> dict:
    """Rank 0's run, after holding it bit for bit to the single-process
    one and every rank's to rank 0's."""
    first = runs[0]
    assert first["losses"] == first["want"] and first["differ"] == []
    assert all(r["losses"] == first["losses"]
               and r["digest"] == first["digest"] for r in runs)
    return first


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("arch", ["mamba2-780m", "gpt2-medium"])
def test_sharded_train_step_over_ranks_is_the_single_process_step(arch,
                                                                  world):
    _agree(_spawn(_train_ranks, world, arch, None))


def test_train_step_over_ranks_matches_the_reference():
    """mamba2-780m over 4 ranks from the reference's parameters, against
    the reference's own two steps, within test_torch_gspmd.py's bands."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from repro import models as RM
    from repro.configs import get_config as ref_get_config
    from repro.distributed.sharding import use_mesh as ref_use_mesh
    from repro.training import optimizer as ref_opt
    from repro.training import train_loop as ref_tl
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from test_torch_gspmd import GRAD_BAND, LOSS_RTOL, PARAM_ATOL, _rel

    arch = "mamba2-780m"
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    rp_np = jax.device_get(RM.init_params(rcfg, jax.random.PRNGKey(0)))
    first = _agree(_spawn(_train_ranks, 4, arch, rp_np))
    losses, state = first["losses"], first["state"]
    rmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), AXES)
    rp = jax.tree.map(jax.numpy.asarray, rp_np)
    ro = ref_opt.adamw_init(rp)
    source = SyntheticLM(cfg, DataConfig(**DATA))
    rstep = ref_tl.jit_train_step(rcfg, rmesh, rp, source.batch(0),
                                  ref_opt.OptConfig(**OC))
    ref_losses = []
    for i in range(STEPS):
        with ref_use_mesh(rmesh):
            rp, ro, rm = rstep(rp, ro, {k: jax.numpy.asarray(v) for k, v in
                                        source.batch(i).items()})
        ref_losses.append(float(rm["loss"]))
    for got, want in zip(losses, ref_losses):
        assert got == pytest.approx(want, rel=LOSS_RTOL)

    def flat(tree, pre):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}
        a = np.asarray(tree)
        return {pre: a.astype(np.float32) if a.dtype.kind in "fV" else a}

    for k, v in flat(jax.device_get(rp), "/params").items():
        np.testing.assert_allclose(state[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    for k, v in flat({"m": jax.device_get(ro["m"]),
                      "v": jax.device_get(ro["v"])}, "").items():
        assert _rel(state[k], v) <= GRAD_BAND, k


# --------------------------------------------------------------------------
# the gpt2_block program through lower(sharding=...)
# --------------------------------------------------------------------------

S, D = 16, 64
FORCED = {"CODO_COLLECTIVE_RING_BYTES": "0", "CODO_COLLECTIVE_RSAG_BYTES": "0"}


def _program(rank, world, forced):
    """gpt2_block through codo_torch.compile on the rank mesh and on the
    single-process mesh, seeded weights: whether every output is bit for
    bit, the vias of the plan, verify() on the rank mesh."""
    os.environ.update(forced)
    import codo_torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import dataflow_models as dm
    rng = np.random.default_rng(SEED + 2)
    outs, vias = [], None
    for mesh in (_mesh(world), make_debug_mesh(SHAPE, AXES, device="cpu")):
        program = codo_torch.compile(dm.gpt2_block_fn, (S, D), device="cpu",
                                     mesh=mesh, sharding_strategy="dp_tp",
                                     cache=None)
        if not outs:
            arrays = {b.name: (rng.standard_normal(b.shape)
                               / np.sqrt(b.shape[0])).astype(np.float32)
                      for b in program.graph.inputs()
                      + program.graph.weights()}
        program.bind(**codo_torch.params_from_numpy(
            {k: v for k, v in arrays.items() if k != "x"}, program.graph,
            "cpu"))
        outs.append(program(arrays["x"]))
        if vias is None:
            vias = sorted({s.via for s in program.sharding.steps})
            program.verify(arrays["x"])
    return torch.equal(outs[0], outs[1]), vias


@pytest.mark.parametrize("forced", [{}, FORCED], ids=["vias", "forced"])
def test_sharded_program_over_ranks_is_the_single_process_program(forced):
    for same, vias in _spawn(_program, 4, forced):
        assert same
        if forced:
            assert set(vias) - {"direct"}, vias


# --------------------------------------------------------------------------
# the serve and prefill steps over ranks
# --------------------------------------------------------------------------

SLOTS, CACHE, DECODES = 8, 16, 3


def _serve_ranks(rank, world, arch):
    """Three decode steps and a prefill over the rank mesh and on the
    single-process mesh: the names of the outputs and cache leaves that
    differ."""
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_paths
    from repro_torch.serving import generator as gen
    cfg = get_config(arch).smoke()
    p0 = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                       device="cpu")
    rng = np.random.default_rng(SEED + 3)
    tokens = rng.integers(0, cfg.vocab, (SLOTS, 32)).astype(np.int32)
    runs = []
    for mesh in (_mesh(world), make_debug_mesh(SHAPE, AXES, device="cpu")):
        cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
        step = gen.jit_serve_step(cfg, mesh, p0, cache)
        tok, seen = np.arange(SLOTS, dtype=np.int32) * 7 % 50, {}
        for i in range(DECODES):
            tok, logits, cache = step(p0, tok, cache)
            seen[f"logits {i}"] = logits
            tok = tok.gather()
            seen[f"tokens {i}"] = tok
        seen.update({k: v.gather() for k, v in tree_paths(cache,
                                                          "").items()})
        batch = {"tokens": tokens}
        seen["prefill"] = gen.jit_prefill_step(cfg, mesh, p0, batch)(p0,
                                                                       batch)
        runs.append(seen)
    return [k for k in runs[1] if not torch.equal(runs[0][k], runs[1][k])]


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
def test_serve_and_prefill_over_ranks_are_the_single_process_steps(arch):
    for differ in _spawn(_serve_ranks, 2, arch):
        assert differ == []
