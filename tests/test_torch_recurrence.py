"""The recurrence and attention-tail paths of the port against the JAX
reference, on the CPU.

* The ``rglru_scan`` and ``ssd_scan`` op bodies against the reference
  registry's ``lax.scan`` bodies, on inputs in each recurrence's domain
  (gates in [0.5, 0.999), decays in [0.5, 0.99)), rtol 1e-6 / atol 2e-6:
  the same float32 recurrence step by step, XLA:CPU and torch rounding
  each step alike or within an ulp.
* Structure: the ``mha_batched``, ``rglru_block`` and ``ssd_block``
  builders and their hand-built twins carry the reference's structural
  hashes; the pattern registry holds the reference's names in its order.
* Routing: the forced and unforced route plans equal the reference's for
  the three workloads and the bare attention tail ``matmul(softmax(s), v)``
  (``sm_tail``, as ``tests/test_costmodel_routing.py`` builds it); with
  ``streamfuse.softmaxmm`` registered, ``gpt2_block``, the train step's
  backward and ResNet-18 route exactly as before; the neutral ``cuda``
  gate routes all four patterns at the full-width shapes (planning only).
* End to end: ``codo_torch.compile(..., device="cpu")`` against
  ``codo.compile`` on the same inputs, forced and by default, within the
  reference's ``verify`` band 1e-5, and the port's own ``verify``.

The CUDA kernels run only on the card (``chip_smoke.py``).
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core import frontend as ref_F  # noqa: E402
from repro.core import ops as ref_ops  # noqa: E402
from repro.core.compiler import codo_opt as ref_codo_opt  # noqa: E402
from repro.core.routing import registered_patterns as ref_patterns  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro.models.rglru import rglru_block_fn as ref_rglru_fn  # noqa: E402
from repro.models.ssm import ssd_block_fn as ref_ssd_fn  # noqa: E402
from repro.models.transformer import \
    mha_batched_fn as ref_mha_fn  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core import ops, routing  # noqa: E402
from repro_torch.core.autodiff import build_train_graphs  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.kernels import rglru, ssd, streamfuse  # noqa: E402
from repro_torch.kernels.rglru.rglru import (HELD,  # noqa: E402
                                             chunk_length, launches)
from repro_torch.models import dataflow_models as dm  # noqa: E402
from repro_torch.models.rglru import rglru_block_fn  # noqa: E402
from repro_torch.models.ssm import ssd_block_fn  # noqa: E402
from repro_torch.models.transformer import mha_batched_fn  # noqa: E402

OP_BAND = dict(rtol=1e-6, atol=2e-6)
BAND = dict(rtol=1e-5, atol=1e-5)          # the reference's verify band


def sm_tail_fn(s, v):
    """The bare attention tail: a softmax whose producer is outside the
    group, then the matmul that consumes it."""
    return F.matmul(F.softmax(s), v)


def ref_sm_tail_fn(s, v):
    return ref_F.matmul(ref_F.softmax(s), v)


def _gates(shape, rng):
    return rng.uniform(0.5, 0.999, shape).astype(np.float32)


def _decays(shape, rng):
    return rng.uniform(0.5, 0.99, shape).astype(np.float32)


def _normal(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# Workload -> (port fn, reference fn, shapes, inputs in the model's domain
# from a seeded generator, the pattern its chain routes to).
WORKLOADS = {
    "mha_batched": (mha_batched_fn, ref_mha_fn, [(4, 64, 32)] * 3,
                    lambda r: [_normal((4, 64, 32), r) for _ in range(3)],
                    "pallas:flashattn.mha"),
    "rglru_block": (rglru_block_fn, ref_rglru_fn, [(2, 128, 64)] * 3,
                    lambda r: [_gates((2, 128, 64), r),
                               _normal((2, 128, 64), r),
                               _normal((2, 128, 64), r)],
                    "pallas:rglru.scan"),
    "ssd_block": (ssd_block_fn, ref_ssd_fn, [(8, 8, 32, 32), (8, 8, 1, 1)],
                  lambda r: [_normal((8, 8, 32, 32), r, 0.1),
                             _decays((8, 8, 1, 1), r)],
                  "pallas:ssd.scan"),
    "sm_tail": (sm_tail_fn, ref_sm_tail_fn, [(64, 64), (64, 48)],
                lambda r: [_normal((64, 64), r), _normal((64, 48), r)],
                "pallas:streamfuse.softmaxmm"),
}


# --------------------------------------------------------------------------
# op bodies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shapes,domain", [
    ("rglru_scan", [(2, 300, 24), (2, 300, 24)], (_gates, _normal)),
    ("ssd_scan", [(12, 4, 8, 16), (12, 4, 1, 1)], (_normal, _decays)),
])
def test_recurrence_op_bodies_match_reference(kind, shapes, domain):
    rng = np.random.default_rng(0)
    arrays = [make(s, rng) for make, s in zip(domain, shapes)]
    spec = ops.OpSpec(kind, ("x", "y"), ("h",))
    got = ops.materialize(spec)({"x": torch.from_numpy(arrays[0]),
                                 "y": torch.from_numpy(arrays[1])})["h"]
    want = ref_ops.materialize(ref_ops.OpSpec(kind, ("x", "y"), ("h",)))(
        {"x": arrays[0], "y": arrays[1]})["h"]
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_BAND)


def test_rglru_body_holds_over_a_long_sequence():
    """At S = 2048 a cumulative product of gates underflows float32; the
    loop never forms one, and stays finite and equal to the oracle."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(_gates((1, 2048, 8), rng))
    b = torch.from_numpy(_normal((1, 2048, 8), rng))
    assert float(a.double().prod(dim=1).min()) < 1e-38
    spec = ops.OpSpec("rglru_scan", ("a", "b"), ("h",))
    h = ops.materialize(spec)({"a": a, "b": b})["h"]
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(h.numpy(), rglru.rglru_ref(a, b).numpy(),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# structure and registry
# --------------------------------------------------------------------------

def test_recurrence_benches_match_reference():
    assert list(dm.RECURRENCE_BENCHES) == list(ref_dm.RECURRENCE_BENCHES)
    for name, build in dm.RECURRENCE_BENCHES.items():
        ours = build().structural_hash()
        assert ours == ref_dm.RECURRENCE_BENCHES[name]().structural_hash()
        traced, hand = dm.HANDBUILT_BENCHES[name]
        assert traced is build and hand().structural_hash() == ours


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_traced_workload_hash_matches_reference(name):
    fn, ref_fn, shapes, _, _ = WORKLOADS[name]
    ours = dm.trace(fn, *shapes, name=name)
    theirs = ref_dm.trace(ref_fn, *shapes, name=name)
    assert ours.structural_hash() == theirs.structural_hash()


def test_registered_patterns_match_reference():
    routing.ensure_kernel_patterns()
    from repro.core.routing import ensure_kernel_patterns
    ensure_kernel_patterns()
    assert [p.name for p in routing.registered_patterns()] == \
        [p.name for p in ref_patterns()] == [
            "streamfuse.conv", "streamfuse.mmchain", "streamfuse.softmaxmm",
            "streamfuse.mmgrad", "flashattn.mha", "rglru.scan", "ssd.scan"]
    pats = {p.name: p for p in routing.registered_patterns()}
    assert pats["rglru.scan"].allow_single and pats["ssd.scan"].allow_single
    assert not pats["streamfuse.softmaxmm"].allow_single


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def _plans(name):
    fn, ref_fn, shapes, _, _ = WORKLOADS[name]
    a = codo_opt(dm.trace(fn, *shapes, name=name), cache=None)
    b = ref_codo_opt(ref_dm.trace(ref_fn, *shapes, name=name), cache=None)
    return (routing.route_plan(a.graph, a.buffer_plan.impl),
            ref_route_plan(b.graph, b.buffer_plan.impl))


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_route_plan_matches_reference(name, forced, monkeypatch):
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    plan, ref_plan = _plans(name)
    assert plan == ref_plan
    routed = [g["kernel"] for g in plan if g["routes"]]
    assert routed == ([WORKLOADS[name][4]] if forced else [])


def test_earlier_paths_route_as_before_with_the_tail_registered(monkeypatch):
    """``streamfuse.softmaxmm`` is registered and matches the bare tail,
    yet ``flashattn.mha`` still claims gpt2_block's attention chain whole,
    the train step's backward keeps its two mmgrad chains and ResNet-18
    its six conv chains — the plans of the earlier slices, unchanged."""
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    assert "streamfuse.softmaxmm" in {p.name for p in
                                      routing.registered_patterns()}

    def kernels(graph):
        c = codo_opt(graph, cache=None)
        plan = routing.route_plan(c.graph, c.buffer_plan.impl)
        return [g["kernel"] for g in plan if g["routes"]], plan

    gpt2, plan = kernels(dm.gpt2_block(16, 64))
    assert gpt2 == ["pallas:flashattn.mha+streamfuse.mmchain"]
    routes = [r["kernel"] for g in plan for r in g["routes"]]
    assert routes == ["flashattn.mha", "streamfuse.mmchain"]
    graphs = build_train_graphs(dm.gpt2_block_loss(32, 64))
    assert kernels(graphs.forward)[0] == kernels(graphs.update)[0] == []
    assert kernels(graphs.backward)[0] == ["pallas:streamfuse.mmgrad"] * 2
    # forced at 32 x 32: the 3-channel stem and the five stride-1 chains
    assert Counter(kernels(dm.resnet18(32))[0]) == {
        "pallas:streamfuse.conv": 6}


# The slice's full-width shapes: RecurrentGemma-9B (d_model 4096, local
# window 2048; 16 heads of 256), Mamba-2 780M (48 heads of 64, d_state
# 128, chunk 256 at S = 4096, B = 2) and one GPT-2-medium head.
FULL_WIDTH = [
    ("rglru_block", lambda: dm.rglru_block(2, 2048, 4096), "rglru.scan"),
    ("ssd_block", lambda: dm.ssd_block(16, 96, 64, 128), "ssd.scan"),
    ("mha_batched", lambda: dm.mha_batched(16, 2048, 256), "flashattn.mha"),
    ("sm_tail_gpt2", lambda: dm.trace(sm_tail_fn, (1024, 1024), (1024, 64)),
     "streamfuse.softmaxmm"),
    ("sm_tail_rg9b", lambda: dm.trace(sm_tail_fn, (2048, 2048), (2048, 256)),
     "streamfuse.softmaxmm"),
]


@pytest.mark.parametrize("name,build,kernel", FULL_WIDTH,
                         ids=[c[0] for c in FULL_WIDTH])
def test_cuda_gate_routes_the_slice_at_full_width(name, build, kernel,
                                                  monkeypatch):
    """Planning only: each chain of the slice still matches at its
    published width on the ``cuda`` backend, and the fitted parameters
    decide it as the card measured (PERF.md §6): the two scans and the
    softmax tail (at parity with the generic path, both captured) route;
    flash loses to the generic path and stays there."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    c = codo_opt(build(), cache=None)
    plan = routing.route_plan(c.graph, c.buffer_plan.impl)
    routes = [r for g in plan for r in g["routes"]]
    matched = routes + [r for g in plan for r in g["rejected"]]
    assert [r["kernel"] for r in matched] == [kernel]
    fitted_win = kernel in ("rglru.scan", "ssd.scan",
                            "streamfuse.softmaxmm")
    assert len(routes) == int(fitted_win)
    assert matched[0]["decision"] == ("predicted-win" if fitted_win
                                      else "predicted-loss")


@pytest.mark.parametrize("name,build,kernel", FULL_WIDTH[:2],
                         ids=[c[0] for c in FULL_WIDTH[:2]])
def test_scan_factories_take_the_full_width_chain(name, build, kernel):
    """The reference's TPU factories decline these chains (their whole
    operands exceed ``vmem_ok``'s 12 MiB: 64 MiB a and b, 48 MiB of
    states), so on a TPU the route never runs at the width it was written
    for; the port's factories build the step."""
    from repro.kernels.common import vmem_ok
    routing.ensure_kernel_patterns()
    c = codo_opt(build(), cache=None)
    (task,) = [t for t in c.graph.tasks if t.op == "scan"]
    pat = {p.name: p for p in routing.registered_patterns()}[kernel]
    assert pat.feasible(c.graph, [task])
    shapes = [c.graph.buffers[b].shape for b in task.spec.ins]
    assert not vmem_ok(*(shapes if kernel == "rglru.scan" else shapes[:1]))
    assert callable(pat.factory(c.graph, None, [task]))


def test_route_chunk_fills_the_card():
    """The rglru route's chunk at (2, 2048, 4096): 64 steps, the most a
    thread holds in registers, 32 chunks of 8192 channels — five waves of
    the card's resident threads — and one launch at any shape.  A narrower
    sequence halves the chunk until one wave is full (32 steps at one
    batch of 1024 channels), never below 16 steps."""
    assert chunk_length(2, 2048, 4096) == 64 == HELD
    assert chunk_length(1, 2048, 1024) == 32
    assert chunk_length(2, 128, 64) == 16
    assert launches() == 1


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_slice_matches_reference_end_to_end(name, forced, monkeypatch):
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    fn, ref_fn, shapes, inputs, kernel = WORKLOADS[name]
    ours = codo_torch.compile(fn, *shapes, device="cpu")
    theirs = codo.compile(ref_fn, *shapes)
    kernels = [g.kernel for g in ours.lower().groups]
    assert kernels == [g.kernel for g in theirs.lower(jit=False).groups]
    assert (kernel in kernels) == forced
    xs = inputs(np.random.default_rng(3))
    got = ours(*xs)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs(*xs)), **BAND)
    ours.verify(*xs)


def test_cpu_routes_launch_no_kernel(monkeypatch):
    """The routed steps on CPU tensors run the plain versions and build
    nothing."""
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    libs = (rglru.LIBRARY, ssd.LIBRARY, streamfuse.SOFTMAX_LIBRARY)
    before = [lib.launches for lib in libs]
    for name in ("rglru_block", "ssd_block", "sm_tail"):
        fn, _, shapes, inputs, _ = WORKLOADS[name]
        codo_torch.compile(fn, *shapes, device="cpu")(
            *inputs(np.random.default_rng(4)))
    assert [lib.launches for lib in libs] == before
    assert all(lib._lib is None for lib in libs)
