"""The reference's ``jit`` switch in the port, and the captured step
runner behind it (``repro_torch.core.capture``), on the CPU.

``jit`` sits where the reference has it, with its defaults, on ``lower``,
``CompiledProgram.lower`` / ``__call__`` and ``CompiledTrainStep.
value_and_grad`` / ``step``, so a positional ``lower(c, False)`` means
what it means in the reference: no jit, kernels still routed.  On the CPU
``jit=True`` runs the step list as it is, so its answers equal
``jit=False``'s bit for bit; the CUDA graphs themselves are held against
eager runs on the card (``chip_smoke.py``'s capture phase).
"""

import inspect
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.api import CompiledProgram as RefProgram  # noqa: E402
from repro.api import CompiledTrainStep as RefTrainStep  # noqa: E402
from repro.core import lowering as ref_lowering  # noqa: E402
from repro.core.ops import OpSpec as RefOpSpec  # noqa: E402
from repro.core.ops import materialize as ref_materialize  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.api import CompiledProgram, CompiledTrainStep  # noqa: E402
from repro_torch.core import capture, lowering  # noqa: E402
from repro_torch.core.ops import OpSpec, materialize  # noqa: E402
from repro_torch.kernels.common import (CudaLibrary,  # noqa: E402
                                        recording_launches)
from repro_torch.models import dataflow_models as dm  # noqa: E402

FORCED_GPT2 = "pallas:flashattn.mha+streamfuse.mmchain"


def _params(kind_fn):
    return list(inspect.signature(kind_fn).parameters.values())


def _jit(fn):
    """(position, kind, default) of ``fn``'s ``jit`` parameter."""
    params = _params(fn)
    i = [p.name for p in params].index("jit")
    return i, params[i].kind, params[i].default


@pytest.mark.parametrize("ours, theirs", [
    (lowering.lower, ref_lowering.lower),
    (lowering.lower_artifact, ref_lowering.lower_artifact),
    (CompiledProgram.lower, RefProgram.lower),
    (CompiledProgram.__call__, RefProgram.__call__),
    (CompiledTrainStep.value_and_grad, RefTrainStep.value_and_grad),
    (CompiledTrainStep.step, RefTrainStep.step),
], ids=["lower", "lower_artifact", "program.lower", "program.__call__",
        "value_and_grad", "step"])
def test_jit_sits_where_the_reference_has_it(ours, theirs):
    assert _jit(ours) == _jit(theirs)
    assert _jit(ours)[2] is True


def test_lower_positional_parameters_match_the_reference():
    names = [p.name for p in _params(lowering.lower)
             if p.kind == p.POSITIONAL_OR_KEYWORD]
    ref = [p.name for p in _params(ref_lowering.lower)
           if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert names == ref == ["compiled", "jit", "use_registered_kernels"]


def test_lower_false_routes_as_the_reference(monkeypatch):
    """``lower(c, False)`` turns jit off and keeps the kernels, in both
    packages (it used to turn the port's kernels off)."""
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    ours = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    theirs = codo.compile(ref_dm.gpt2_block_fn, (16, 64))
    mine = [g.kernel for g in lowering.lower(ours.compiled, False,
                                             device="cpu").groups]
    ref = [g.kernel for g in ref_lowering.lower(theirs.compiled,
                                                False).groups]
    assert mine == ref == [FORCED_GPT2]
    off = lowering.lower(ours.compiled, False, False, device="cpu")
    assert [g.kernel for g in off.groups] == ["xla-fused"]


def test_memo_keeps_jit_apart():
    """Both flags of one design are two entries; a structurally identical
    fresh compile hits each (as ``test_lower_memoization_structural``
    checks for the reference)."""
    def compiled():
        return codo_torch.compile(dm.feed_forward_fn, (8, 16), device="cpu",
                                  cache=None).compiled

    lowering.clear_lower_cache()
    c = compiled()
    on = lowering.lower(c, jit=True, device="cpu")
    off = lowering.lower(c, jit=False, device="cpu")
    assert lowering.LOWER_CACHE_STATS == {"hits": 0, "misses": 2}
    assert isinstance(on.fn, capture.CapturedProgram)
    assert not isinstance(off.fn, capture.CapturedProgram)
    again = compiled()
    assert lowering.lower(again, jit=True, device="cpu").fn is on.fn
    assert lowering.lower(again, jit=False, device="cpu").fn is off.fn
    assert lowering.LOWER_CACHE_STATS == {"hits": 2, "misses": 2}


def test_program_lower_is_memoized_per_jit():
    p = codo_torch.compile(dm.feed_forward_fn, (8, 16), device="cpu")
    eager, captured = p.lower(jit=False), p.lower(jit=True)
    assert isinstance(captured.fn, capture.CapturedProgram)
    assert not isinstance(eager.fn, capture.CapturedProgram)
    assert p.lower(jit=True) is captured and p.lower() is captured
    assert p.lower(jit=False) is not captured


def _seeded(graph, seed):
    rng = np.random.default_rng(seed)
    return {b.name: (rng.standard_normal(b.shape) / np.sqrt(b.shape[0])
                     ).astype(np.float32) for b in graph.weights()}


@pytest.mark.parametrize("forced", [False, True])
def test_jit_equals_eager_on_the_cpu(forced, monkeypatch):
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    p = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    p.bind(**codo_torch.params_from_numpy(_seeded(p.graph, 3), p.graph,
                                          "cpu"))
    before = dict(capture.CAPTURE_STATS)
    x = np.random.default_rng(4).standard_normal((16, 64)).astype(np.float32)
    got, want = p(x), p(x, jit=False)
    assert torch.equal(got, want)
    assert capture.CAPTURE_STATS == before      # nothing captured here


def test_three_train_steps_equal_with_and_without_jit(monkeypatch):
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    step = codo_torch.compile(dm.gpt2_block_loss_fn, (8, 32), (8, 32),
                              device="cpu", grad=True)
    rng = np.random.default_rng(5)
    params0 = codo_torch.params_from_numpy(_seeded(step.source, 6),
                                           step.source, "cpu")
    x, t = (rng.standard_normal((8, 32)).astype(np.float32)
            for _ in range(2))
    runs = {}
    for jit in (True, False):
        params, state = dict(params0), step.init_opt_state()
        trail = []
        for _ in range(3):
            params, state, metrics = step.step(params, state, x, t, jit=jit)
            trail.append((dict(params), {k: dict(state[k]) for k in "mv"},
                          dict(metrics)))
        runs[jit] = trail
        loss, grads = step.value_and_grad(x, t, params=params, jit=jit)
        runs[jit].append(({"loss": loss}, {"grads": grads}, {}))
    for a, b in zip(runs[True], runs[False]):
        for da, db in zip(a, b):
            for k in da:
                va, vb = da[k], db[k]
                if isinstance(va, dict):
                    assert all(torch.equal(va[w], vb[w]) for w in va), k
                else:
                    assert torch.equal(va, vb), k


def test_const_is_made_once_with_the_same_values():
    value = ((1.5, -2.0, 3.25), (0.1, 0.2, 0.3))
    spec = OpSpec("const", (), ("c",), {"value": value, "dtype": "float32"})
    env = {"x": torch.zeros(2)}
    first = materialize(spec)(env)["c"]
    again = materialize(spec)(env)["c"]
    assert again is first                       # one tensor, no new copy
    want = np.asarray(ref_materialize(RefOpSpec(
        "const", (), ("c",), {"value": value, "dtype": "float32"}))({})["c"])
    assert first.dtype == torch.float32
    np.testing.assert_array_equal(first.numpy(), want)
    np.testing.assert_array_equal(first.numpy(),
                                  np.array(value, dtype=np.float32))
    other = OpSpec("const", (), ("c",), {"value": value, "dtype": "float64"})
    assert materialize(other)(env)["c"].dtype == torch.float64


def test_captured_program_runs_eagerly_off_the_card():
    steps = [("double", lambda s: {"y": s["x"] * 2}),
             ("inc", lambda s: {"z": s["y"] + 1})]
    prog = capture.CapturedProgram(steps, ["z"])
    x = torch.arange(4.0)
    assert torch.equal(prog({"x": x})["z"], x * 2 + 1)
    assert capture.graph_count() == 0
    # numpy values are not tensors: run eagerly too
    assert np.array_equal(prog({"x": np.arange(4.0)})["z"],
                          np.arange(4.0) * 2 + 1)


def test_static_buffers_keep_the_layout():
    base = torch.randn(6, 4)
    view = base.t()                             # a transposed view
    static = capture._static_like(view)
    assert static.shape == view.shape and static.stride() == view.stride()
    wide = torch.randn(4, 1).expand(4, 5)       # a stride-0 dimension
    static = capture._static_like(wide)
    assert static.shape == wide.shape and static.is_contiguous()
    sig_a = capture._signature("cuda:0", {"k": view})
    sig_b = capture._signature("cuda:0", {"k": view.contiguous()})
    assert sig_a != sig_b


class _FakeLib:
    """A loaded library whose every entry point returns CUDA success."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launches_recorded_while_capturing_count_on_replay():
    lib = CudaLibrary("chain.cu", {})
    lib._lib = _FakeLib()
    lib.launch("codo_matmul_chain")
    assert lib.launches == 1
    record = Counter()
    with recording_launches(record):
        lib.launch("codo_matmul_chain")
        lib.launch("codo_matmul_chain_reduce")
    assert lib.launches == 1                    # enqueued, not executed
    assert record == Counter({(lib, "codo_matmul_chain"): 1,
                              (lib, "codo_matmul_chain_reduce"): 1})
    for (which, name), n in record.items():     # what a replay does
        which.count(name, n)
    assert lib.launches == 3
    assert lib.entry_launches == Counter({"codo_matmul_chain": 2,
                                          "codo_matmul_chain_reduce": 1})
    lib.launch("codo_matmul_chain")             # recording ended
    assert lib.launches == 4


def test_clear_lower_cache_releases_graphs():
    capture._GRAPHS[("test", "sig")] = object()
    assert capture.graph_count() == 1
    lowering.clear_lower_cache()
    assert capture.graph_count() == 0


def test_a_collected_program_releases_its_graphs():
    """A graph pins its bound entries (a generator's weights and cache):
    it goes with its program."""
    import gc
    program = capture.CapturedProgram([], [], bound=("x",))
    other = capture.CapturedProgram([], [])
    capture._GRAPHS[(program.serial, "sig")] = object()
    capture._GRAPHS[(other.serial, "sig")] = object()
    assert program.graphs() == other.graphs() == 1
    del program
    gc.collect()
    assert other.graphs() == 1 and capture.graph_count() == 1
    other.release()
    assert capture.graph_count() == 0
