"""The port's sharded lowering on the CPU, held against the reference.

``repro_torch.distributed`` (plan, partition, collectives),
``repro_torch.launch.mesh`` and the lockstep interpreter of
``repro_torch.core.lowering`` against ``repro.distributed`` and the
reference's lowering, in process and with no spawned rank: every position
of a 4 x 2 debug mesh is the CPU (``make_debug_mesh(..., device="cpu")``),
the port's counterpart of the reference's eight forced host devices.

* the plan's data classes round-trip and validate as the reference's do;
* the port's plans equal the reference's — digest, steps and
  ``estimated_cycles`` — for every strategy and ``auto`` on
  ``gpt2_block(64, 128)``, with and without the forcing thresholds;
* under forced routing the routed and ``"sharded"`` chains equal the
  reference's ``_drop_sharded_routes``;
* each collective: the ring and ``rs_ag`` bit for bit ``direct``;
* every strategy and both forced vias within ``verify_sharding``'s band
  (rtol 1e-4 / atol 5e-5) of the reference's single-device lowering on
  the same numpy inputs, ``replicate`` bit for bit the port's own
  single-device program, and a plan missing one collective failing;
* ``codo_torch.compile(mesh=)``, export and load crossing both ways with
  equal digests, and the raises: ``grad=True`` with a mesh, too few
  cards, ``jit=True`` on a mesh over several cards.
"""

import json
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core import lowering as ref_lowering  # noqa: E402
from repro.core import routing as ref_routing  # noqa: E402
from repro.core.compiler import codo_opt as ref_codo_opt  # noqa: E402
from repro.distributed import partition as ref_partition  # noqa: E402
from repro.distributed.plan import MeshSpec as RefMeshSpec  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import lowering  # noqa: E402
from repro_torch.core.capture import CaptureError  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.partition import (PartitionError,  # noqa: E402
                                               partition)
from repro_torch.distributed.plan import (COLLECTIVE_KINDS,  # noqa: E402
                                          CollectiveStep, MeshSpec,
                                          ShardingPlan, ShardSpec)
from repro_torch.launch.mesh import (Mesh, make_debug_mesh,  # noqa: E402
                                     mesh_from_spec)
from repro_torch.models import dataflow_models as dm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESH42 = MeshSpec((("data", 4), ("model", 2)))
REF_MESH42 = RefMeshSpec((("data", 4), ("model", 2)))
STRATEGIES = ("replicate", "dp", "tp", "dp_tp", "auto")
BAND = dict(rtol=1e-4, atol=5e-5)           # verify_sharding's
S, D = 64, 128
FORCED = {"CODO_COLLECTIVE_RING_BYTES": "0", "CODO_COLLECTIVE_RSAG_BYTES": "0"}


@pytest.fixture(scope="module")
def designs():
    """gpt2_block(64, 128) through codo_opt in both packages."""
    return (codo_opt(dm.gpt2_block(S, D), cache=None),
            ref_codo_opt(ref_dm.gpt2_block(S, D), cache=None))


@pytest.fixture(scope="module")
def arrays(designs):
    """Distinct seeded inputs and weights, as numpy, over the square root
    of their fan-in (the shape-keyed initializer would make wq, wk and wv
    equal and hide a swapped shard)."""
    rng = np.random.default_rng(0)
    graph = designs[0].graph
    return {b.name: (rng.standard_normal(b.shape) / np.sqrt(b.shape[0])
                     ).astype(np.float32)
            for b in graph.inputs() + graph.weights()}


@pytest.fixture(scope="module")
def reference_out(designs, arrays):
    """The reference's single-device ``lower(jit=False)`` on the arrays
    (its generic path: the same function on either route)."""
    got = ref_lowering.lower(designs[1], jit=False,
                             use_registered_kernels=False)(dict(arrays))
    return {k: np.asarray(v) for k, v in got.items()}


@pytest.fixture
def forced_routing(monkeypatch):
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)


def _env(arrays):
    return {k: torch.as_tensor(v) for k, v in arrays.items()}


def _cpu_mesh(shape=(4, 2), axes=("data", "model")):
    return make_debug_mesh(shape, axes, device="cpu")


# --------------------------------------------------------------------------
# plan.py: the reference's plan checks on the port's classes
# --------------------------------------------------------------------------


def test_mesh_spec_roundtrip_and_validation():
    assert MESH42.size == 8 and MESH42.names == ("data", "model")
    assert MeshSpec.from_dict(MESH42.to_dict()) == MESH42
    assert MESH42.to_dict() == REF_MESH42.to_dict()
    assert MeshSpec.of(_cpu_mesh()) == MESH42
    with pytest.raises(ValueError):
        MeshSpec((("data", 2), ("data", 4)))       # duplicate axis
    with pytest.raises(ValueError):
        MeshSpec((("data", 0),))                   # non-positive size


def test_shard_spec_local_shape_and_validation():
    s = ShardSpec(("data", None))
    assert s.shard_factor(MESH42) == 4
    assert s.local_shape((8, 6), MESH42) == (2, 6)
    assert ShardSpec((None, None)).is_replicated
    with pytest.raises(ValueError):
        ShardSpec(("data", "data"))                # same axis on two dims
    assert COLLECTIVE_KINDS == ("all_gather", "reduce_scatter", "psum",
                                "ppermute")


def test_sharding_plan_digest_is_stable_and_tamper_checked():
    plan = partition(dm.gpt2_block(32, 64), MESH42, "dp")
    again = partition(dm.gpt2_block(32, 64), MESH42, "dp")
    assert plan.digest() == again.digest()
    doc = plan.to_dict()
    assert ShardingPlan.from_dict(doc).digest() == plan.digest()
    doc["strategy"] = "tp"                         # tamper
    with pytest.raises(ValueError, match="digest"):
        ShardingPlan.from_dict(doc)


# --------------------------------------------------------------------------
# partition.py + collectives.build_steps: the reference's plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("forced", [False, True], ids=["direct", "forced"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plans_equal_the_reference(strategy, forced, designs, monkeypatch):
    """Digest, specs, steps (sizes and vias included) and
    ``estimated_cycles``: the whole document, from a compiled design, and
    from the port's placed mesh as from its pure-data spec."""
    for k, v in FORCED.items():
        if forced:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    ours, theirs = designs
    plan = partition(ours, MESH42, strategy)
    ref = ref_partition.partition(theirs, REF_MESH42, strategy)
    assert plan.to_dict() == ref.to_dict()
    assert plan.digest() == ref.digest()
    assert plan.estimated_cycles == ref.estimated_cycles > 0
    assert partition(ours, _cpu_mesh(), strategy) == plan
    if forced and plan.strategy in ("tp", "dp_tp"):
        assert ("psum", "rs_ag") in {(s.kind, s.via) for s in plan.steps}
    if forced and plan.strategy in ("dp", "dp_tp"):
        assert ("all_gather", "ring") in {(s.kind, s.via) for s in plan.steps}


# The digests chip_smoke.py's sharding phase printed for gpt2_block at
# GPT-2-medium width on the card (NVIDIA H100 80GB HBM3, 700 W): by S, the
# strategy each name resolved to and its digest.  At S=1024 the default
# thresholds already pick the ring and rs_ag, so dp_tp's digest is the
# one S=128 gets with both forced.
CARD_DIGESTS = {
    128: {"replicate": ("replicate", "33d18d4f00a7dd19"),
          "dp": ("dp", "ba96bbec8091e1f7"), "tp": ("tp", "d40e7b1d3b03d567"),
          "dp_tp": ("dp_tp", "a7103a99466566d8"),
          "auto": ("dp_tp", "a7103a99466566d8")},
    1024: {"replicate": ("replicate", "33d18d4f00a7dd19"),
           "dp": ("dp", "0dce163f0ce26821"), "tp": ("tp", "3f70ed6538dbcdf3"),
           "dp_tp": ("dp_tp", "95500b8d57988a57"),
           "auto": ("dp_tp", "95500b8d57988a57")},
}


@pytest.mark.parametrize("seq", sorted(CARD_DIGESTS))
def test_card_plans_are_the_references(seq, monkeypatch):
    """The plans the card's phase ran, at (S, 1024), are the reference's
    for the same design: digest, whole document and strategy ``auto``
    picks."""
    for k in FORCED:
        monkeypatch.delenv(k, raising=False)
    ours = codo_opt(dm.gpt2_block(seq, 1024), cache=None)
    theirs = ref_codo_opt(ref_dm.gpt2_block(seq, 1024), cache=None)
    for strategy, (resolved, digest) in CARD_DIGESTS[seq].items():
        plan = partition(ours, MESH42, strategy)
        ref = ref_partition.partition(theirs, REF_MESH42, strategy)
        assert plan.to_dict() == ref.to_dict()
        assert (plan.strategy, plan.digest()) == (resolved, digest)


def test_partition_rejects_bad_inputs():
    g = dm.gpt2_block(32, 64)
    with pytest.raises(PartitionError, match="unknown strategy"):
        partition(g, MESH42, "nope")
    with pytest.raises(PartitionError, match="tensor axis"):
        partition(g, MeshSpec((("data", 8),)), "tp")
    with pytest.raises(TypeError, match="MeshSpec"):
        partition(g, object(), "dp")


def _route_table(groups):
    return [(g.kernel, g.decision, [r.kernel for r in g.routes],
             [(r.kernel, r.decision, tuple(r.tasks)) for r in g.rejected])
            for g in groups]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_routes_equal_the_reference(strategy, designs,
                                            forced_routing):
    """Under forced routing, which chains keep their kernel and which a
    collective un-routes (``"sharded"``), against the reference's own
    ``_drop_sharded_routes`` over its route plan."""
    ours, theirs = designs
    plan = partition(ours, MESH42, strategy)
    got = lowering.lower(ours, jit=False, device="cpu", sharding=plan,
                         mesh=_cpu_mesh())
    impl = theirs.buffer_plan.impl
    ref_routing.ensure_kernel_patterns()
    groups = ref_lowering.fusion_groups(theirs.graph, impl)
    ref_routing.route_groups(theirs.graph, groups, impl, hw=theirs.options.hw)
    ref_lowering._drop_sharded_routes(
        groups, ref_partition.partition(theirs, REF_MESH42, strategy))
    assert _route_table(got.groups) == _route_table(groups)
    kernels = [g.kernel for g in got.groups]
    if plan.strategy == "replicate":
        assert kernels == ["pallas:flashattn.mha+streamfuse.mmchain"]
    else:        # a gather lands inside the attention chain: only the FFN
        assert kernels == ["pallas:streamfuse.mmchain"]
        assert [r.decision for g in got.groups for r in g.rejected] == [
            "sharded"]


# --------------------------------------------------------------------------
# collectives: one function over a group's local shards
# --------------------------------------------------------------------------


def _step(kind, via, dim=0):
    return CollectiveStep(kind=kind, buffer="b", axis="data", task="t",
                          where="before" if kind == "all_gather" else "after",
                          dim=dim, via=via)


@pytest.mark.parametrize("dim", [0, 1])
def test_ring_all_gather_is_bit_for_bit_direct(dim):
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(4, 6, generator=g) for _ in range(4)]
    ring = coll.make_collective(_step("all_gather", "ring", dim), MESH42)(xs)
    direct = coll.make_collective(_step("all_gather", "direct", dim),
                                  MESH42)(xs)
    want = torch.cat(xs, dim)
    assert len(ring) == len(direct) == 4
    for r, d in zip(ring, direct):
        assert torch.equal(r, d) and torch.equal(d, want)


def test_rs_ag_psum_is_bit_for_bit_direct():
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(8, 5, generator=g) * 10 ** i for i in range(4)]
    rs_ag = coll.make_collective(_step("psum", "rs_ag"), MESH42)(xs)
    direct = coll.make_collective(_step("psum", "direct"), MESH42)(xs)
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]        # position order
    for r, d in zip(rs_ag, direct):
        assert torch.equal(r, d) and torch.equal(d, want)


def test_psum_over_two_positions_is_the_sum():
    x0, x1 = torch.randn(3, 4), torch.randn(3, 4)
    model = CollectiveStep(kind="psum", buffer="b", axis="model", task="t")
    got = coll.make_collective(model, MESH42)([x0, x1])
    assert all(torch.equal(y, x0 + x1) for y in got)


def test_mesh_groups_run_along_one_axis():
    mesh = _cpu_mesh()
    assert mesh.coords(5) == {"data": 2, "model": 1}
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert mesh.distinct_devices == (torch.device("cpu"),)


# --------------------------------------------------------------------------
# the lockstep interpreter against the reference's numerics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES + ("dp_tp forced vias",))
def test_sharded_lowering_within_band_of_the_reference(
        strategy, designs, arrays, reference_out, forced_routing,
        monkeypatch):
    if strategy.endswith("forced vias"):
        for k, v in FORCED.items():
            monkeypatch.setenv(k, v)
        strategy = "dp_tp"
    ours = designs[0]
    plan = partition(ours, MESH42, strategy)
    mesh = _cpu_mesh()
    env = _env(arrays)
    got = lowering.lower(ours, jit=False, device="cpu", sharding=plan,
                         mesh=mesh)(dict(env))
    assert set(got) == set(reference_out)
    for k, want in reference_out.items():
        assert tuple(got[k].shape) == want.shape
        np.testing.assert_allclose(got[k].numpy(), want, **BAND)
    lowering.verify_sharding(ours, plan, dict(env), mesh=mesh)


def test_replicate_is_bit_for_bit_the_single_device_program(
        designs, arrays, forced_routing):
    ours = designs[0]
    plan = partition(ours, MESH42, "replicate")
    env = _env(arrays)
    single = lowering.lower(ours, jit=False, device="cpu")(dict(env))
    sharded = lowering.lower(ours, jit=False, device="cpu", sharding=plan,
                             mesh=_cpu_mesh())(dict(env))
    assert all(torch.equal(sharded[k], single[k]) for k in single)


@pytest.mark.parametrize("strategy, kind, error, match", [
    ("tp", "psum", AssertionError, "sharded lowering diverged"),
    ("dp", "all_gather", RuntimeError, "."),
], ids=["psum", "all_gather"])
def test_a_plan_missing_a_collective_fails_verify(strategy, kind, error,
                                                  match, designs, arrays):
    """Without its psum a row-parallel product keeps one position's
    partial sum (the right shape, O(1) off); without its gather a
    consumer meets a shard where it needs the whole buffer."""
    ours = designs[0]
    plan = partition(ours, MESH42, strategy)
    i = next(i for i, s in enumerate(plan.steps) if s.kind == kind)
    broken = replace(plan, steps=plan.steps[:i] + plan.steps[i + 1:])
    assert broken.digest() != plan.digest()
    with pytest.raises(error, match=match):
        lowering.verify_sharding(ours, broken, _env(arrays),
                                 mesh=_cpu_mesh())


def test_sharded_program_refuses_unexpected_env_keys(designs, arrays):
    from repro_torch.core.graph import GraphError
    ours = designs[0]
    run = lowering.lower(ours, jit=False, device="cpu",
                         sharding=partition(ours, MESH42, "dp"),
                         mesh=_cpu_mesh())
    env = _env(arrays)
    with pytest.raises(GraphError, match="unexpected env keys"):
        run({**env, "stray": torch.zeros(1)})
    with pytest.raises(GraphError, match="missing env keys"):
        run({k: v for k, v in env.items() if k != "x"})


def test_lowering_memo_keys_the_plan_and_the_mesh(designs):
    ours = designs[0]
    dp = partition(ours, MESH42, "dp")
    tp = partition(ours, MESH42, "tp")
    mesh = _cpu_mesh()
    a = lowering.lower(ours, jit=False, device="cpu", sharding=dp, mesh=mesh)
    assert lowering.lower(ours, jit=False, device="cpu", sharding=dp,
                          mesh=_cpu_mesh()).fn is a.fn
    assert lowering.lower(ours, jit=False, device="cpu", sharding=tp,
                          mesh=mesh).fn is not a.fn
    assert lowering.lower(ours, jit=False, device="cpu").fn is not a.fn
    with pytest.raises(ValueError, match="plan is for mesh"):
        lowering.lower(ours, jit=False, sharding=dp,
                       mesh=_cpu_mesh((2, 4)))


def test_jit_on_one_device_runs_the_same_lockstep(designs, arrays):
    ours = designs[0]
    plan = partition(ours, MESH42, "dp_tp")
    env = _env(arrays)
    eager = lowering.lower(ours, jit=False, device="cpu", sharding=plan,
                           mesh=_cpu_mesh())(dict(env))
    jitted = lowering.lower(ours, jit=True, device="cpu", sharding=plan,
                            mesh=_cpu_mesh())(dict(env))
    assert all(torch.equal(jitted[k], eager[k]) for k in eager)


def test_jit_on_a_mesh_over_several_cards_raises(designs):
    """Capturing across cards is not ported; it raises naming its
    ROADMAP.md item (a mesh of card devices needs no card to build)."""
    ours = designs[0]
    cards = Mesh(MESH42, [torch.device("cuda", i) for i in range(8)])
    with pytest.raises(CaptureError) as err:
        lowering.lower(ours, jit=True, sharding=partition(ours, MESH42, "dp"),
                       mesh=cards)
    m = re.search(r"Queue 1 item (\d+) \(([\w-]+) ", str(err.value))
    queue = (REPO / "ROADMAP.md").read_text().split("### Queue 1")[1]
    queue = queue.split("### Queue 2")[0]
    item = re.search(rf"^{m.group(1)}\. \*\*(.+?)\*\*", queue, re.M)
    assert item and item.group(1).startswith(m.group(2)), item


# --------------------------------------------------------------------------
# the API and artifacts, both ways
# --------------------------------------------------------------------------


def test_compile_mesh_verifies_and_crosses_to_the_reference(arrays,
                                                             tmp_path):
    weights = {k: v for k, v in arrays.items() if k != "x"}
    ours = codo_torch.compile(dm.gpt2_block_fn, (S, D), device="cpu",
                              mesh=_cpu_mesh(), sharding_strategy="dp_tp")
    ours.bind(**codo_torch.params_from_numpy(weights, ours.graph, "cpu"))
    assert ours.sharding.strategy == "dp_tp"
    ours.verify(arrays["x"])
    path = tmp_path / "sharded.json"
    ours.export(str(path), weights=True)
    theirs = codo.load(str(path))
    assert theirs.sharding.digest() == ours.sharding.digest()
    back = codo_torch.load(str(path), device="cpu")
    assert back.sharding.digest() == ours.sharding.digest()
    assert torch.equal(back(arrays["x"]), ours(arrays["x"]))


def test_reference_sharded_artifact_loads_in_the_port(arrays):
    theirs = codo.compile(ref_dm.gpt2_block_fn, (S, D), mesh=REF_MESH42,
                          sharding_strategy="tp", cache=None)
    weights = {k: v for k, v in arrays.items() if k != "x"}
    doc = json.loads(json.dumps(theirs.export(weights=weights)))
    ours = codo_torch.load(doc, device="cpu")
    assert ours.sharding.digest() == theirs.sharding.digest()
    assert ours.sharding.to_dict() == theirs.sharding.to_dict()
    assert ours.mesh is None                    # placed at first lowering
    got = ours(arrays["x"])
    assert ours.mesh.distinct_devices == (torch.device("cpu"),)
    want = ref_lowering.lower(theirs.compiled, jit=False,
                              use_registered_kernels=False)(dict(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[
        theirs.output_names[0]]), **BAND)
    ours.verify(arrays["x"])


def test_grad_with_mesh_raises_and_too_few_cards_raise():
    with pytest.raises(codo_torch.TraceError, match="mesh"):
        codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                           device="cpu", grad=True, mesh=MESH42)
    with pytest.raises(RuntimeError, match="make_debug_mesh"):
        mesh_from_spec(MESH42)
    program = codo_torch.compile(dm.gpt2_block_fn, (8, 16), device="cpu")
    with pytest.raises(ValueError, match="differ from the program's device"):
        program.shard(Mesh(MESH42, ["cuda:0"] * 8))
