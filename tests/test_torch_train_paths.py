"""The port's train steps over a CNN loss and the two recurrence losses,
against the reference ``CompiledTrainStep`` on the CPU.

Three scalar losses, written here (as ``tests/test_torch_train.py``
takes ``gpt2_block_loss_fn`` from the models):

* ``cnn``: pad → conv → relu → maxpool (k = 2 over an odd 17 × 17) →
  conv at stride 2 over a ragged 10 × 10 (its last row and column unread)
  → a depthwise conv (groups = C) → global mean → fc → MSE, at (2, 3, 17,
  17).  Its backward holds every conv gradient case: ``conv2d_input_grad``
  and ``conv2d_weight_grad`` at stride 1 and 2 and grouped,
  ``maxpool2d_grad`` over relu'd (tied) windows, ``mean_grad``,
  ``relu_grad`` and the pads' ``slice``.
* ``rglru``: ``d = rglru_block_fn(a, gate, x) − target``, ``mean_all(d·d)``
  at (2, 128, 64), differentiated with respect to its operands ``a`` and
  ``gate`` (it has no weights); ``x`` and ``target`` are passed by name.
* ``ssd``: the same over ``ssd_block_fn(states, decay)`` at (8, 8, 32,
  32), with respect to ``states`` and ``decay``.

Both packages compile each with ``grad=True`` under forced routing (the
reference's Pallas kernels in interpret mode, the port's plain versions
on CPU tensors) and take the same seeded inputs in each model's domain
(gates in [0.5, 1), decays below 1).  The graphs carry the reference's
hashes and route plans (each scan routed in the forward, nothing in the
backward or the update); loss and gradients agree within rtol 1e-4 /
atol 1e-5, and so do three AdamW steps, banded as in
``tests/test_torch_train.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core import frontend as ref_F  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.models.rglru import rglru_block_fn as ref_rglru_fn  # noqa: E402
from repro.models.ssm import ssd_block_fn as ref_ssd_fn  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core.routing import route_plan  # noqa: E402
from repro_torch.models.rglru import rglru_block_fn  # noqa: E402
from repro_torch.models.ssm import ssd_block_fn  # noqa: E402

STEPS = 3
GRAD_BAND = dict(rtol=1e-4, atol=1e-5)
PHASES = ("forward", "backward", "update")
CNN_SHAPE = (2, 3, 17, 17)
RGLRU_SHAPE = (2, 128, 64)
SSD_SHAPE = (8, 8, 32, 32)
SSD_DECAY = (8, 8, 1, 1)


def _mse(F, y, target):
    d = F.sub(y, target)
    return F.mean_all(F.mul(d, d))


def cnn_loss(F):
    """The small CNN's MSE loss, in one package's frontend ``F``."""
    def cnn_loss_fn(x, target):
        h = F.conv(x, 8, 3)                       # pad -> conv -> relu
        h = F.maxpool(h, 2)                       # 17 -> 8, edge dropped
        h = F.conv(h, 16, 3, stride=2)            # 10 -> 4, reads 9 of 10
        h = F.conv(h, 16, 3, depthwise=True)      # groups = C
        return _mse(F, F.fc(F.global_avgpool(h), 10), target)
    return cnn_loss_fn


def rglru_loss(F, block):
    def rglru_loss_fn(a, gate, x, target):
        return _mse(F, block(a, gate, x), target)
    return rglru_loss_fn


def ssd_loss(F, block):
    def ssd_loss_fn(states, decay, target):
        return _mse(F, block(states, decay), target)
    return ssd_loss_fn


def _cnn_inputs(step, rng):
    params = {}
    for b in step.source.weights():
        fan_in = int(np.prod(b.shape[1:])) if len(b.shape) == 4 else b.shape[0]
        params[b.name] = (rng.standard_normal(b.shape) / np.sqrt(fan_in)
                          ).astype(np.float32)
    return params, {"x": rng.standard_normal(CNN_SHAPE).astype(np.float32),
                    "target": rng.standard_normal((2, 10)).astype(np.float32)}


def _rglru_inputs(step, rng):
    params = {"a": rng.uniform(0.5, 1.0, RGLRU_SHAPE).astype(np.float32),
              "gate": rng.uniform(0.0, 1.0, RGLRU_SHAPE).astype(np.float32)}
    return params, {k: rng.standard_normal(RGLRU_SHAPE).astype(np.float32)
                    for k in ("x", "target")}


def _ssd_inputs(step, rng):
    params = {"states": (0.1 * rng.standard_normal(SSD_SHAPE)
                         ).astype(np.float32),
              "decay": rng.uniform(0.5, 0.99, SSD_DECAY).astype(np.float32)}
    return params, {"target": (0.1 * rng.standard_normal(SSD_SHAPE)
                               ).astype(np.float32)}


# name -> (port loss, reference loss, specs, wrt, inputs, the forward's
# routed groups under forced routing)
PATHS = {
    "cnn": (cnn_loss(F), cnn_loss(ref_F), [CNN_SHAPE, (2, 10)], None,
            _cnn_inputs, []),
    "rglru": (rglru_loss(F, rglru_block_fn), rglru_loss(ref_F, ref_rglru_fn),
              [RGLRU_SHAPE] * 4, ("a", "gate"), _rglru_inputs,
              ["pallas:rglru.scan"]),
    "ssd": (ssd_loss(F, ssd_block_fn), ssd_loss(ref_F, ref_ssd_fn),
            [SSD_SHAPE, SSD_DECAY, SSD_SHAPE], ("states", "decay"),
            _ssd_inputs, ["pallas:ssd.scan"]),
}


def _routed(program, **kw):
    return [(g.kernel, [r.tasks for r in g.routes])
            for g in program.lower(**kw).groups if g.routes]


def _run(name):
    fn, ref_fn, specs, wrt, make_inputs, _ = PATHS[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODO_FORCE_PALLAS", "1")
        mp.setenv("CODO_PALLAS_INTERPRET", "1")
        mp.delenv("CODO_DISABLE_PALLAS", raising=False)
        mp.delenv("CODO_BACKEND", raising=False)
        ours = codo_torch.compile(fn, *specs, grad=True, device="cpu",
                                  wrt=wrt)
        theirs = codo.compile(ref_fn, *specs, grad=True, wrt=wrt)
        params, named = make_inputs(ours, np.random.default_rng(7))
        ref_state = theirs.init_opt_state(params)
        p, s = codo_torch.train_state_from_numpy(params, ref_state, ours)
        out = {"ours": ours, "theirs": theirs, "params": params,
               "named": named,
               "vag": ours.value_and_grad(params=p, **named),
               "ref_vag": theirs.value_and_grad(params=params, **named),
               "routed": {ph: _routed(getattr(ours, ph)) for ph in PHASES},
               "ref_routed": {ph: _routed(getattr(theirs, ph), jit=False)
                              for ph in PHASES},
               "steps": [], "ref_steps": []}
        ref_p, ref_s = params, ref_state
        for _ in range(STEPS):
            p, s, m = ours.step(p, s, **named)
            out["steps"].append((p, s, m))
            ref_p, ref_s, ref_m = theirs.step(ref_p, ref_s, **named)
            out["ref_steps"].append((ref_p, ref_s, ref_m))
        out["verify"] = ours.verify(params=p, **named)
    return out


@pytest.fixture(scope="module", params=sorted(PATHS))
def run(request):
    return request.param, _run(request.param)


def test_train_graphs_carry_the_reference_hashes(run):
    name, r = run
    ours, theirs = r["ours"], r["theirs"]
    assert ours.param_names == theirs.param_names
    assert ours.graphs.residuals == theirs.graphs.residuals
    assert ours.graphs.grads == theirs.graphs.grads
    for ph in PHASES:
        a, b = getattr(ours.graphs, ph), getattr(theirs.graphs, ph)
        assert a.structural_hash() == b.structural_hash(), ph
        ca, cb = getattr(ours, ph).compiled, getattr(theirs, ph).compiled
        assert ca.graph.structural_hash() == cb.graph.structural_hash(), ph
        assert ca.final.total_cycles == cb.final.total_cycles, ph


def test_operands_are_the_parameters_and_the_rest_pass_by_name(run):
    name, r = run
    ours = r["ours"]
    wrt = PATHS[name][3]
    if wrt is None:
        assert ours.param_names == sorted(b.name for b in
                                          ours.source.weights())
    else:
        assert ours.param_names == sorted(wrt)
        kinds = {ours.source.buffers[w].kind for w in wrt}
        assert kinds == {"input"}
    assert set(r["named"]) | set(ours.param_names) >= set(ours.input_names)


def test_forced_route_plan_matches_reference(run):
    name, r = run
    for ph in PHASES:
        ca = getattr(r["ours"], ph).compiled
        cb = getattr(r["theirs"], ph).compiled
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("CODO_FORCE_PALLAS", "1")
            plan = route_plan(ca.graph, ca.buffer_plan.impl)
            assert plan == ref_route_plan(cb.graph, cb.buffer_plan.impl), ph
        assert r["routed"][ph] == r["ref_routed"][ph], ph
        kernels = [k for k, _ in r["routed"][ph]]
        assert kernels == (PATHS[name][5] if ph == "forward" else []), ph


def test_backward_holds_the_gradient_kinds(run):
    name, r = run
    kinds = {t.spec.kind for t in r["ours"].graphs.backward.tasks}
    want = {"cnn": {"conv2d_input_grad", "conv2d_weight_grad",
                    "maxpool2d_grad", "mean_grad", "relu_grad", "slice"},
            "rglru": {"rglru_scan_grad"}, "ssd": {"ssd_scan_grad"}}[name]
    assert want <= kinds
    if name == "cnn":
        convs = [t.spec.attrs for t in r["ours"].graphs.backward.tasks
                 if t.spec.kind == "conv2d_input_grad"]
        assert {(a["stride"], a["groups"] > 1) for a in convs} >= {
            (1, False), (2, False), (1, True)}


def test_loss_and_grads_match_reference(run):
    name, r = run
    loss, grads = r["vag"]
    ref_loss, ref_grads = r["ref_vag"]
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               **GRAD_BAND)
    assert sorted(grads) == sorted(ref_grads)
    for w, g in grads.items():
        assert g.shape == np.shape(ref_grads[w])
        assert bool(g.abs().max() > 0), w
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[w]),
                                   err_msg=w, **GRAD_BAND)


@pytest.mark.parametrize("i", range(STEPS))
def test_adamw_steps_match_reference(run, i):
    name, r = run
    p, s, m = r["steps"][i]
    ref_p, ref_s, ref_m = r["ref_steps"][i]
    for w in r["ours"].param_names:
        np.testing.assert_allclose(p[w].numpy(), np.asarray(ref_p[w]),
                                   rtol=1e-6, atol=1e-7, err_msg=w)
        np.testing.assert_allclose(s["m"][w].numpy(),
                                   np.asarray(ref_s["m"][w]), rtol=1e-4,
                                   atol=1e-8, err_msg=f"m {w}")
        np.testing.assert_allclose(s["v"][w].numpy(),
                                   np.asarray(ref_s["v"][w]), rtol=2e-4,
                                   atol=1e-10, err_msg=f"v {w}")
    assert int(s["step"]) == int(ref_s["step"]) == i + 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), **GRAD_BAND)
    np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)


def test_verify_holds_each_tensor_to_its_scale(run):
    name, r = run
    report = r["verify"]
    assert set(report) == {"loss", *r["ours"].param_names}
    for key, (err, scale) in report.items():
        assert scale > 0.0, key
        assert err <= 1e-4 * scale, (key, err, scale)


@pytest.mark.parametrize("name,specs,kernel", [
    ("rglru", [(2, 2048, 4096)] * 4, "rglru.scan"),
    ("ssd", [(16, 96, 64, 128), (16, 96, 1, 1), (16, 96, 64, 128)],
     "ssd.scan"),
])
def test_cuda_gate_routes_the_scan_in_the_forward_at_full_width(
        name, specs, kernel, monkeypatch):
    """Planning only: at the published widths the fitted ``cuda``
    parameters (the scans' efficiency clamped at 2.0, PERF.md §6)
    route each train step's scan in its forward, and nothing in the
    backward or the update."""
    from repro_torch.core.autodiff import build_train_graphs
    from repro_torch.core.compiler import codo_opt
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    fn, _, _, wrt, _, _ = PATHS[name]
    graphs = build_train_graphs(F.trace(fn, *specs, name=f"{name}_loss"),
                                wrt=wrt)
    for ph in PHASES:
        c = codo_opt(getattr(graphs, ph), cache=None)
        routes = [r for g in route_plan(c.graph, c.buffer_plan.impl)
                  for r in g["routes"]]
        assert [r["kernel"] for r in routes] == (
            [kernel] if ph == "forward" else []), ph
        assert {r["decision"] for r in routes} <= {"predicted-win"}


def test_verify_runs_the_oracles_backward_in_full_float32(monkeypatch):
    """The oracle's conv gradients come from autograd, whose backward
    convolutions read cuDNN's TF32 flag when they run: verify() turns it
    off around them, as the conv2d body does for the forward."""
    step = codo_torch.compile(cnn_loss(F), (1, 3, 9, 9), (1, 10), grad=True,
                              device="cpu")
    seen = []
    real = torch.autograd.grad

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.autograd, "grad", spy)
    rng = np.random.default_rng(3)
    step.verify(rng.standard_normal((1, 3, 9, 9)).astype(np.float32),
                rng.standard_normal((1, 10)).astype(np.float32))
    assert seen == [False] and torch.backends.cudnn.allow_tf32
