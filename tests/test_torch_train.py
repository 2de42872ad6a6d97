"""The port's train step (``codo_torch.compile(..., grad=True)``) against
the reference ``CompiledTrainStep`` on the CPU.

Both packages differentiate ``gpt2_block_loss_fn`` at (32, 64).  The
graphs must carry the reference's structural hashes and, under forced
routing, the reference's route plan: two ``streamfuse.mmgrad`` chains in
the backward (the port runs the kernel's plain version here, the
reference its Pallas kernel in interpret mode), none in the forward or the
update.  The same distinct seeded parameters, inputs and optimizer state
go to both (the shape-keyed ``weight_init`` would make wq, wk, wv equal).

Bands, tighter than the reference's own verify band (rtol 2e-3 /
atol 1e-4): loss and gradients rtol 1e-4 / atol 1e-5 — the two packages
run the same float32 graph, differing only in summation order inside
each matmul and reduction (observed ≤ 4e-7 absolute).  After AdamW steps,
moments follow the gradients (m linearly: rtol 1e-4; v quadratically:
rtol 2e-4), parameters move by lr ≤ 1.2e-5 a step so they agree to a few
ulps (rtol 1e-6 / atol 1e-7), and the learning rate and step counter are
the same float32 arithmetic (rtol 1e-6, exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.kernels.streamfuse.ops import \
    _grad_ew_applier as ref_grad_ew_applier  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core.autodiff import build_train_graphs  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.core.routing import route_plan  # noqa: E402
from repro_torch.kernels.streamfuse import GRAD_LIBRARY  # noqa: E402
from repro_torch.kernels.streamfuse.ops import grad_tail  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402

SHAPE = (32, 64)
STEPS = 3
GRAD_BAND = dict(rtol=1e-4, atol=1e-5)
PHASES = ("forward", "backward", "update")
MMGRAD = "pallas:streamfuse.mmgrad"
# The two routed backward chains of gpt2_block_loss (task names of both
# packages): the FFN's cotangent matmul into gelu_grad, and the attention
# scores' cotangent matmul into softmax_grad and the score scale.
CHAINS = [["d14_mm_t", "d20_gelu_grad_t"],
          ["d42_mm_t", "d48_softmax_grad_t", "d50_scale_t"]]


def _seeded(step_source, seed=0):
    rng = np.random.default_rng(seed)
    params = {b.name: (rng.standard_normal(b.shape) / np.sqrt(b.shape[0])
                       ).astype(np.float32) for b in step_source.weights()}
    x, t = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    return params, x, t


def _routed(program):
    return [(g.kernel, [r.tasks for r in g.routes])
            for g in program.lower().groups if g.routes]


@pytest.fixture(scope="module")
def runs():
    """Both train steps compiled and run once, with the chains forced
    onto the kernel route (the reference's Pallas kernel in interpret
    mode); every later test reads these results."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODO_FORCE_PALLAS", "1")
        mp.setenv("CODO_PALLAS_INTERPRET", "1")
        mp.delenv("CODO_DISABLE_PALLAS", raising=False)
        mp.delenv("CODO_BACKEND", raising=False)
        ours = codo_torch.compile(dm.gpt2_block_loss_fn, SHAPE, SHAPE,
                                  grad=True, device="cpu")
        theirs = codo.compile(ref_dm.gpt2_block_loss_fn, SHAPE, SHAPE,
                              grad=True)
        params, x, t = _seeded(ours.source)
        assert len({w.tobytes() for w in params.values()}) == len(params)
        ref_state = theirs.init_opt_state(params)
        p, s = codo_torch.train_state_from_numpy(params, ref_state, ours)
        launches = GRAD_LIBRARY.launches
        out = {"ours": ours, "theirs": theirs, "params": params, "x": x,
               "t": t, "vag": ours.value_and_grad(x, t, params=p),
               "ref_vag": theirs.value_and_grad(x, t, params=params),
               "routed": {ph: _routed(getattr(ours, ph)) for ph in PHASES},
               "ref_routed": {ph: [(g.kernel, [r.tasks for r in g.routes])
                                   for g in getattr(theirs, ph).lower(
                                       jit=False).groups if g.routes]
                              for ph in PHASES},
               "steps": [], "ref_steps": []}
        ref_p, ref_s = params, ref_state
        for _ in range(STEPS):
            p, s, m = ours.step(p, s, x, t)
            out["steps"].append((p, s, m))
            ref_p, ref_s, ref_m = theirs.step(ref_p, ref_s, x, t)
            out["ref_steps"].append((ref_p, ref_s, ref_m))
        out["launched"] = GRAD_LIBRARY.launches - launches
        out["verify"] = ours.verify(x, t, params=p)
    return out


def test_train_graphs_carry_the_reference_hashes(runs):
    ours, theirs = runs["ours"], runs["theirs"]
    assert ours.graphs.loss == theirs.graphs.loss
    assert ours.graphs.residuals == theirs.graphs.residuals
    assert ours.graphs.grads == theirs.graphs.grads
    assert ours.graphs.opt == theirs.graphs.opt
    for ph in PHASES:
        a, b = getattr(ours.graphs, ph), getattr(theirs.graphs, ph)
        assert a.structural_hash() == b.structural_hash(), ph
        ca, cb = getattr(ours, ph).compiled, getattr(theirs, ph).compiled
        assert ca.graph.structural_hash() == cb.graph.structural_hash(), ph
        assert ca.final.total_cycles == cb.final.total_cycles, ph


@pytest.mark.parametrize("phase", PHASES)
def test_forced_route_plan_matches_reference(runs, phase):
    ca = getattr(runs["ours"], phase).compiled
    cb = getattr(runs["theirs"], phase).compiled
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODO_FORCE_PALLAS", "1")
        plan = route_plan(ca.graph, ca.buffer_plan.impl)
        assert plan == ref_route_plan(cb.graph, cb.buffer_plan.impl)
    routes = [r["tasks"] for g in plan for r in g["routes"]]
    assert routes == (CHAINS if phase == "backward" else [])
    assert runs["routed"][phase] == runs["ref_routed"][phase]
    kernels = [k for k, _ in runs["routed"][phase]]
    assert kernels == ([MMGRAD, MMGRAD] if phase == "backward" else [])


@pytest.mark.parametrize("S", [128, 1024])
def test_cuda_gate_routes_both_chains_at_full_width(S, monkeypatch):
    """Planning only: the backward's two chains of the GPT-2-medium-width
    train step still match at full width, and the fitted ``cuda``
    parameters (mmgrad's efficiency 1.44, PERF.md §6) route both,
    and nothing else."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    graphs = build_train_graphs(dm.trace(dm.gpt2_block_loss_fn, (S, 1024),
                                         (S, 1024), name="gpt2_block_loss"))
    for ph in PHASES:
        c = codo_opt(getattr(graphs, ph), cache=None)
        routes = [r for g in route_plan(c.graph, c.buffer_plan.impl)
                  for r in g["routes"]]
        assert [r["tasks"] for r in routes] == (
            CHAINS if ph == "backward" else [])
        assert {r["decision"] for r in routes} <= {"predicted-win"}


def test_loss_and_grads_match_reference(runs):
    loss, grads = runs["vag"]
    ref_loss, ref_grads = runs["ref_vag"]
    assert isinstance(loss, torch.Tensor) and loss.shape == (1, 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               **GRAD_BAND)
    assert sorted(grads) == sorted(ref_grads) == runs["ours"].param_names
    for w, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[w]),
                                   err_msg=w, **GRAD_BAND)


@pytest.mark.parametrize("i", range(STEPS))
def test_adamw_steps_match_reference(runs, i):
    p, s, m = runs["steps"][i]
    ref_p, ref_s, ref_m = runs["ref_steps"][i]
    for w in runs["ours"].param_names:
        np.testing.assert_allclose(p[w].numpy(), np.asarray(ref_p[w]),
                                   rtol=1e-6, atol=1e-7, err_msg=w)
        np.testing.assert_allclose(s["m"][w].numpy(),
                                   np.asarray(ref_s["m"][w]), rtol=1e-4,
                                   atol=1e-8, err_msg=f"m {w}")
        np.testing.assert_allclose(s["v"][w].numpy(),
                                   np.asarray(ref_s["v"][w]), rtol=2e-4,
                                   atol=1e-10, err_msg=f"v {w}")
    assert s["step"].dtype == torch.int32
    assert int(s["step"]) == int(ref_s["step"]) == i + 1
    for k in ("loss", "grad_norm"):
        assert m[k].shape == ()
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), **GRAD_BAND)
    np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)


def test_steps_went_through_the_mmgrad_route_on_the_cpu(runs):
    """The routed chains ran (their plain version: CPU tensors), and no
    kernel was built or launched."""
    assert runs["launched"] == 0 and GRAD_LIBRARY._lib is None
    losses = [float(m["loss"]) for _, _, m in runs["steps"]]
    assert losses[-1] < losses[0]


def test_factory_binds_residuals_in_the_reference_order(runs):
    """The kernel's extras follow ``_grad_ew_applier``'s order, and each
    gradient stage points at its own residual."""
    bwd = runs["ours"].backward.graph
    ref_bwd = runs["theirs"].backward.compiled.graph
    for chain in CHAINS:
        tail = [bwd.task(n) for n in chain[1:]]
        ew, extras = grad_tail(tail)
        _, ref_extras = ref_grad_ew_applier([ref_bwd.task(n)
                                             for n in chain[1:]])
        assert extras == ref_extras and len(extras) == 1
        assert [(k, i) for k, _, i in ew] == [
            (t.spec.kind, 0 if len(t.spec.ins) > 1 else None) for t in tail]


def test_verify_catches_a_wrong_gradient(runs, monkeypatch):
    ours = runs["ours"]
    params = codo_torch.train_state_from_numpy(
        runs["params"], runs["theirs"].init_opt_state(runs["params"]),
        ours)[0]
    real = ours.value_and_grad

    def off_by_one(*a, **kw):
        loss, grads = real(*a, **kw)
        w = ours.param_names[0]
        return loss, {**grads, w: grads[w] + 1.0}

    monkeypatch.setattr(ours, "value_and_grad", off_by_one)
    with pytest.raises(AssertionError, match="grad"):
        ours.verify(runs["x"], runs["t"], params=params)


def test_state_lives_on_the_device_as_tensors(runs):
    ours = runs["ours"]
    params = ours.init_params()
    state = ours.init_opt_state(params)
    assert set(params) == set(ours.param_names)
    for w in ours.param_names:
        assert params[w].device == ours.device
        assert not state["m"][w].any() and not state["v"][w].any()
        assert state["m"][w].shape == params[w].shape
    assert state["step"].shape == () and int(state["step"]) == 0
    p, s, m = ours.step(params, state, runs["x"], runs["t"])
    assert all(isinstance(v, torch.Tensor) and v.shape == ()
               for v in m.values())
    assert int(s["step"]) == 1


def test_verify_reports_each_tensor_beside_its_scale(runs):
    """verify() returns (max abs error, max abs oracle value) for the loss
    and every gradient, so the card's smoke run can hold each tensor to a
    band of its own scale; here they agree to the summation order."""
    report = runs["verify"]
    assert set(report) == {"loss", *runs["ours"].param_names}
    for name, (err, scale) in report.items():
        assert scale > 0.0, name
        assert err <= 1e-4 * scale, (name, err, scale)


def test_train_state_from_numpy_checks_what_it_carries(runs):
    ours, params = runs["ours"], runs["params"]
    state = runs["theirs"].init_opt_state(params)
    p, s = codo_torch.train_state_from_numpy(params, state, ours)
    w = ours.param_names[0]
    np.testing.assert_array_equal(p[w].numpy(), params[w])
    assert {p[w].device, s["m"][w].device, s["step"].device} == {ours.device}
    assert s["step"].dtype == torch.int32 and s["m"][w].dtype == torch.float32
    with pytest.raises(KeyError, match="missing"):
        codo_torch.train_state_from_numpy(
            {k: v for k, v in params.items() if k != w}, state, ours)
    bad = {**state, "m": {**state["m"], w: np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        codo_torch.train_state_from_numpy(params, bad, ours)


def test_value_and_grad_method_matches_compile(runs):
    ours = runs["ours"]
    prog = codo_torch.compile(dm.gpt2_block_loss_fn, SHAPE, SHAPE,
                              device="cpu")
    step = prog.value_and_grad()
    assert step.param_names == ours.param_names
    assert step.device == prog.device
    for ph in PHASES:
        assert getattr(step.graphs, ph).structural_hash() == \
            getattr(ours.graphs, ph).structural_hash()
    p = step.init_params()
    l1, g1 = step.value_and_grad(runs["x"], runs["t"], params=p)
    l2, g2 = ours.value_and_grad(runs["x"], runs["t"], params=p)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-7)
    for w in step.param_names:
        torch.testing.assert_close(g1[w], g2[w], rtol=1e-6, atol=1e-7)


def test_train_step_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                           grad=True)


def test_grad_kwargs_guardrails():
    with pytest.raises(codo_torch.TraceError, match="grad=True"):
        codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                           device="cpu", wrt=["wfc3"])
    step = codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                              device="cpu", grad=True, wrt=["wfc3"],
                              opt={"lr": 1e-3})
    assert step.param_names == ["wfc3"]
    assert step.graphs.opt["lr"] == 1e-3
