"""The port's serving runtime on the CPU: the battery of
``tests/test_serving.py`` that concerns the runtime, run on
``repro_torch.serving`` with ``device="cpu"``; the request-coalescing
rebuild (``batch_blockers`` / ``batch_graph``) held against the
reference's on six workloads; and the same seeded requests served through
both packages' runtimes.

Synchronization policy, as in the reference's battery: every wait is
event-based — ``pause``/``resume``/``flush``/``ServeFuture.result(timeout)``
— never a sleep.  ``pause()`` + N ``submit()`` + ``resume()`` is the
deterministic way to place N requests inside one batching window.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core import frontend as ref_frontend  # noqa: E402
from repro.core.compiler import codo_opt as ref_codo_opt  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import frontend  # noqa: E402
from repro_torch.core.cache import CompileCache  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.core.routing import route_plan  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402
from repro_torch.serving import (QueueFullError, ServeConfig,  # noqa: E402
                                 ServeError, ServingRuntime)

TIMEOUT = 300        # generous per-future bound; waits are event-based
CPU = "cpu"


def _model(x):
    h = codo_torch.F.fc(x, 24, relu=True)
    return codo_torch.F.fc(h, 12)


def _bound_program(cache, scale=1.0, shape=(8, 16)):
    """A compiled tiny MLP with deterministic bound weights (``scale``
    makes two observably different model generations)."""
    p = codo_torch.compile(_model, shape, cache=cache, device=CPU)
    w = {b.name: scale * np.asarray(
        codo_torch.F.weight_init(b.shape, b.dtype)) for b in p.graph.weights()}
    p.bind(**w)
    return p


def _inputs(n, shape=(8, 16), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype("float32") for _ in range(n)]


def _runtime(cache, **cfg):
    return ServingRuntime(ServeConfig(**cfg), cache=cache, device=CPU)


def _equal(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --------------------------------------------------------------------------
# Dynamic batching
# --------------------------------------------------------------------------


def test_window_coalesces_to_exactly_one_batched_compile():
    cache = CompileCache()
    p = _bound_program(cache)
    with _runtime(cache, batch_window_ms=500, max_batch=4) as rt:
        rt.add_model("m", p)
        xs = _inputs(4)

        misses0 = cache.stats.misses
        rt.pause()
        futs = [rt.submit("m", x=x) for x in xs]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert len(outs) == 4
        # One dispatch group, all four coalesced, ONE compile for the
        # leading-batch-dim design (cache accounting: exactly one miss).
        assert rt.stats.batches == 1
        assert rt.stats.batched_requests == 4
        assert rt.stats.fallback_requests == 0
        assert cache.stats.misses - misses0 == 1

        # A second identical window re-uses the batched program: zero new
        # compiles anywhere.
        misses1 = cache.stats.misses
        rt.pause()
        futs = [rt.submit("m", x=x) for x in xs]
        rt.resume()
        [f.result(timeout=TIMEOUT) for f in futs]
        assert rt.stats.batches == 2
        assert cache.stats.misses == misses1


def test_batched_results_bit_identical_to_sequential():
    cache = CompileCache()
    p = _bound_program(cache)
    name = p.output_names[0]
    xs = _inputs(6, seed=3)
    want = [p(x) for x in xs]
    with _runtime(cache, batch_window_ms=500, max_batch=6) as rt:
        rt.add_model("m", p)
        rt.pause()
        futs = [rt.submit("m", x=x) for x in xs]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert rt.stats.batched_requests == 6
    for got, ref in zip(outs, want):
        _equal(got[name], ref)                      # bit-identical


def test_requests_take_tensors_and_numpy_alike():
    cache = CompileCache()
    p = _bound_program(cache)
    name = p.output_names[0]
    xs = _inputs(2, seed=5)
    with _runtime(cache, batch_window_ms=500, max_batch=2) as rt:
        rt.add_model("m", p)
        rt.pause()
        futs = [rt.submit("m", x=xs[0]),
                rt.submit("m", x=torch.from_numpy(xs[1]))]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert rt.stats.batched_requests == 2
    for got, x in zip(outs, xs):
        _equal(got[name], p(x))


def test_mixed_shape_traffic_never_cross_batches():
    cache = CompileCache()
    p_a = _bound_program(cache, shape=(8, 16))
    p_b = _bound_program(cache, shape=(4, 16))
    name = p_a.output_names[0]
    xa, xb = _inputs(2, (8, 16), seed=1), _inputs(2, (4, 16), seed=2)
    with _runtime(cache, batch_window_ms=500, max_batch=8) as rt:
        rt.add_model("a", p_a)
        rt.add_model("b", p_b)
        rt.pause()
        futs = [rt.submit("a", x=xa[0]), rt.submit("b", x=xb[0]),
                rt.submit("a", x=xa[1]), rt.submit("b", x=xb[1])]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    # Two dispatch groups — one per model — and every batched program
    # that exists has each model's own shape (no cross-batching).
    assert rt.stats.batches == 2
    for handle, prog in ((rt._models["a"], p_a), (rt._models["b"], p_b)):
        for size, bp in handle.batched.items():
            batched_in = bp.graph.buffers[prog.input_names[0]]
            orig_in = prog.graph.buffers[prog.input_names[0]]
            assert tuple(batched_in.shape) == (size, *orig_in.shape)
    _equal(outs[0][name], p_a(xa[0]))
    _equal(outs[1][name], p_b(xb[0]))
    _equal(outs[2][name], p_a(xa[1]))
    _equal(outs[3][name], p_b(xb[1]))


def test_non_batchable_design_falls_back_per_request():
    cache = CompileCache()
    g = dm.residual_block(1, 8, 12)         # conv ops: not batchable
    p = codo_torch.compile(g, cache=cache, device=CPU)
    assert frontend.batch_blockers(p.source)    # precondition of this test
    env = dm.random_inputs(g, seed=0)
    want = p.lower()(p.make_env(**env))
    with _runtime(cache, batch_window_ms=500, max_batch=3) as rt:
        rt.add_model("m", p, warm=False)
        rt.pause()
        futs = [rt.submit("m", **env) for _ in range(3)]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert rt.stats.fallback_requests == 3
    assert rt.stats.batched_requests == 0
    for out in outs:
        for k in want:
            _equal(out[k], want[k])


# --------------------------------------------------------------------------
# Backpressure + request-path errors
# --------------------------------------------------------------------------


def test_bounded_queue_backpressure():
    cache = CompileCache()
    p = _bound_program(cache)
    with _runtime(cache, batch_window_ms=500, max_batch=4,
                  max_queue=4) as rt:
        rt.add_model("m", p)
        rt.pause()                          # queue fills deterministically
        xs = _inputs(4)
        futs = [rt.submit("m", x=x) for x in xs]
        with pytest.raises(QueueFullError):
            rt.submit("m", x=xs[0])
        rt.resume()
        assert all(f.result(timeout=TIMEOUT) is not None for f in futs)
    assert rt.stats.completed == 4


def test_unknown_model_and_closed_runtime_raise():
    cache = CompileCache()
    p = _bound_program(cache)
    rt = _runtime(cache, batch_window_ms=1)
    rt.add_model("m", p)
    with pytest.raises(KeyError):
        rt.submit("nope", x=_inputs(1)[0])
    rt.close()
    with pytest.raises(ServeError):
        rt.submit("m", x=_inputs(1)[0])


def test_execution_error_is_a_clean_response():
    cache = CompileCache()
    p = _bound_program(cache)
    with _runtime(cache, batch_window_ms=1) as rt:
        rt.add_model("m", p)
        fut = rt.submit("m", wrong_name=_inputs(1)[0])
        with pytest.raises(ServeError, match="execution failed"):
            fut.result(timeout=TIMEOUT)
    assert rt.stats.failed == 1


def test_runtime_needs_a_card_by_default(monkeypatch):
    """Like every entry point of the port, the runtime serves on the card
    unless the caller asks for the CPU, and says so when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRuntime(ServeConfig(), cache=CompileCache())


def test_program_on_another_device_is_refused():
    cache = CompileCache()
    p = _bound_program(cache)
    p.device = torch.device("meta")
    with _runtime(cache, batch_window_ms=1) as rt:
        with pytest.raises(ValueError, match="serves on cpu"):
            rt.add_model("m", p)


# --------------------------------------------------------------------------
# Hot-swap
# --------------------------------------------------------------------------


def test_hot_swap_under_load_loses_zero_requests():
    cache = CompileCache()
    p_old = _bound_program(cache, scale=1.0)
    p_new = _bound_program(cache, scale=2.0)
    name = p_old.output_names[0]
    xs = _inputs(12, seed=7)
    want_old = [p_old(x) for x in xs]
    want_new = [p_new(x) for x in xs]
    with _runtime(cache, batch_window_ms=500, max_batch=4) as rt:
        rt.add_model("m", p_old)
        rt.pause()
        futs = [rt.submit("m", x=x) for x in xs]    # 3 windows queued
        rt.resume()
        # Swap while those requests are in flight/queued: the replacement
        # is warmed before the atomic flip; dispatched work drains on the
        # old design.
        rt.swap("m", p_new)
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert rt.stats.swaps == 1
    assert rt.stats.completed == len(xs)            # zero requests lost
    assert rt.stats.failed == 0
    from_old = from_new = 0
    for got, old, new in zip(outs, want_old, want_new):
        # Every response is *exactly* one generation's answer — a swap
        # mid-stream never yields a mixed or torn result.
        if torch.equal(got[name], old):
            from_old += 1
        elif torch.equal(got[name], new):
            from_new += 1
        else:
            raise AssertionError("response matches neither generation")
    assert from_old + from_new == len(xs)


def test_post_swap_requests_serve_the_new_design():
    cache = CompileCache()
    p_old = _bound_program(cache, scale=1.0)
    p_new = _bound_program(cache, scale=3.0)
    name = p_old.output_names[0]
    x = _inputs(1, seed=9)[0]
    with _runtime(cache, batch_window_ms=1) as rt:
        rt.add_model("m", p_old)
        _equal(rt.submit("m", x=x).result(timeout=TIMEOUT)[name], p_old(x))
        rt.swap("m", p_new)
        _equal(rt.submit("m", x=x).result(timeout=TIMEOUT)[name], p_new(x))
    assert rt.stats.failed == 0


def test_swap_unknown_model_raises():
    cache = CompileCache()
    with _runtime(cache, batch_window_ms=1) as rt:
        with pytest.raises(KeyError):
            rt.swap("ghost", _bound_program(cache))


# --------------------------------------------------------------------------
# Process workers: shared disk cache, crash respawn, bounded retries
# --------------------------------------------------------------------------


def _export_served(tmp_path, cache, scale=1.0):
    p = _bound_program(cache, scale=scale)
    path = tmp_path / f"served_{scale}.json"
    p.export(str(path), weights=True)       # self-contained artifact
    return p, str(path)


def test_worker_pool_serves_batched_and_shares_disk_cache(tmp_path):
    cache = CompileCache(disk_dir=tmp_path / "cache")
    p, path = _export_served(tmp_path, cache)
    name = p.output_names[0]
    xs = _inputs(4, seed=11)
    want = [p(x) for x in xs]
    before = set((tmp_path / "cache").glob("*.pkl"))
    with _runtime(cache, batch_window_ms=200, max_batch=4, workers=1) as rt:
        rt.add_model("m", path)
        rt.pause()
        futs = [rt.submit("m", x=x) for x in xs]
        rt.resume()
        outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert rt.stats.batched_requests == 4
    for got, ref in zip(outs, want):
        _equal(got[name], ref)
    # The worker compiled the batched design through the *shared* disk
    # cache: the parent's cache dir gained entries it can now hit.
    assert set((tmp_path / "cache").glob("*.pkl")) > before


def test_worker_crash_respawns_and_retries_request(tmp_path, monkeypatch):
    marker = tmp_path / "crash.marker"
    marker.write_text("armed")
    monkeypatch.setenv("CODO_SERVE_FAULT", f"crash_once:{marker}")
    cache = CompileCache(disk_dir=tmp_path / "cache")
    p, path = _export_served(tmp_path, cache)
    name = p.output_names[0]
    x = _inputs(1, seed=13)[0]
    with _runtime(cache, batch_window_ms=1, workers=1, max_retries=2) as rt:
        rt.add_model("m", path)
        fut = rt.submit("m", x=torch.from_numpy(x))
        out = fut.result(timeout=TIMEOUT)   # survives the crash
    _equal(out[name], p(x))
    assert not marker.exists()              # the fault actually fired
    assert rt.stats.respawns >= 1           # pool was rebuilt
    assert rt.stats.retries >= 1            # the request was re-queued
    assert rt.stats.completed == 1


def test_worker_crash_bounded_retries_then_clean_error(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("CODO_SERVE_FAULT", "crash")    # dies every time
    cache = CompileCache(disk_dir=tmp_path / "cache")
    _p, path = _export_served(tmp_path, cache)
    x = _inputs(1, seed=17)[0]
    rt = _runtime(cache, batch_window_ms=1, workers=1, max_retries=1)
    try:
        rt.add_model("m", path)
        fut = rt.submit("m", x=x)
        with pytest.raises(ServeError, match="worker crashes"):
            fut.result(timeout=TIMEOUT)
        assert rt.stats.failed == 1
        assert rt.stats.retries == 1        # bounded: exactly max_retries
    finally:
        monkeypatch.setenv("CODO_SERVE_FAULT", "")
        rt.close()


# --------------------------------------------------------------------------
# Config knobs
# --------------------------------------------------------------------------


def test_serve_config_reads_env_knobs(monkeypatch):
    monkeypatch.setenv("CODO_SERVE_BATCH_WINDOW_MS", "7.5")
    monkeypatch.setenv("CODO_SERVE_MAX_QUEUE", "33")
    monkeypatch.setenv("CODO_SERVE_WORKERS", "2")
    cfg = ServeConfig.from_env()
    assert cfg.batch_window_ms == 7.5
    assert cfg.max_queue == 33
    assert cfg.workers == 2
    # overrides beat env; garbage falls back to defaults
    assert ServeConfig.from_env(workers=0).workers == 0
    monkeypatch.setenv("CODO_SERVE_MAX_QUEUE", "not-a-number")
    assert ServeConfig.from_env().max_queue == 256


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


def test_cli_serves_an_artifact_on_the_cpu(tmp_path, capsys):
    from repro_torch.serving import cli
    _p, path = _export_served(tmp_path, CompileCache())
    assert cli.main(["--artifact", path, "--device", "cpu", "--requests",
                     "3", "--batch-window-ms", "500", "--max-batch",
                     "3"]) == 0
    out = capsys.readouterr().out
    assert "3 requests on cpu" in out and "3 batched / 0 per-request" in out


def test_cli_inputs_errors_exit_2(tmp_path, capsys):
    from repro_torch.serving import cli
    _p, path = _export_served(tmp_path, CompileCache())
    bad = tmp_path / "bad.npz"
    np.savez(bad, x=np.zeros((3, 3), np.float32))
    assert cli.main(["--artifact", path, "--device", "cpu", "--inputs",
                     str(bad)]) == 2
    assert "has shape (3, 3), buffer expects (8, 16)" in \
        capsys.readouterr().err


# --------------------------------------------------------------------------
# Request coalescing against the reference
# --------------------------------------------------------------------------


def _ref_model(x):
    h = codo.F.fc(x, 24, relu=True)
    return codo.F.fc(h, 12)


# name -> (the port's graph, the reference's graph); two coalesce, one is
# the runtime battery's MLP, three are blocked (convolutions, scans).
BATCHING = {
    "gpt2_block": (lambda: dm.gpt2_block(16, 64),
                   lambda: ref_dm.gpt2_block(16, 64)),
    "mha_batched": (lambda: dm.mha_batched(2, 32, 16),
                    lambda: ref_dm.mha_batched(2, 32, 16)),
    "mlp": (lambda: frontend.trace(_model, (8, 16), name="mlp"),
            lambda: ref_frontend.trace(_ref_model, (8, 16), name="mlp")),
    "resnet18": (lambda: dm.resnet18(32), lambda: ref_dm.resnet18(32)),
    "rglru_block": (lambda: dm.rglru_block(2, 16, 8),
                    lambda: ref_dm.rglru_block(2, 16, 8)),
    "ssd_block": (lambda: dm.ssd_block(4, 8, 4, 8),
                  lambda: ref_dm.ssd_block(4, 8, 4, 8)),
}
BLOCKED = {"resnet18", "rglru_block", "ssd_block"}


@pytest.mark.parametrize("name", sorted(BATCHING))
def test_batch_blockers_match_reference(name):
    ours, theirs = (build() for build in BATCHING[name])
    got = frontend.batch_blockers(ours)
    assert got == ref_frontend.batch_blockers(theirs)
    assert bool(got) == (name in BLOCKED)


@pytest.mark.parametrize("name", sorted(BATCHING))
def test_batch_graph_matches_reference(name):
    """The same structural hash for the rebuilt batch-of-4 design, or the
    same refusal where the graph cannot take a batch dim."""
    ours, theirs = (build() for build in BATCHING[name])
    if name in BLOCKED:
        with pytest.raises(frontend.TraceError) as got:
            frontend.batch_graph(ours, 4)
        with pytest.raises(ref_frontend.TraceError) as want:
            ref_frontend.batch_graph(theirs, 4)
        assert str(got.value) == str(want.value)
        return
    bg = frontend.batch_graph(ours, 4)
    assert bg.name == f"{ours.name}@b4"
    assert bg.structural_hash() == \
        ref_frontend.batch_graph(theirs, 4).structural_hash()
    for b in ours.inputs():
        assert tuple(bg.buffers[b.name].shape) == (4, *b.shape)
    for b in ours.weights():
        assert tuple(bg.buffers[b.name].shape) == tuple(b.shape)


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
@pytest.mark.parametrize("name", sorted(BATCHING))
def test_batched_route_plans_match_reference(name, forced, monkeypatch):
    """The plan the runtime's batched compile routes (the per-request
    compile's, for a blocked design), forced and under the CPU gate."""
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    ours, theirs = (build() for build in BATCHING[name])
    if name not in BLOCKED:
        ours = frontend.batch_graph(ours, 4)
        theirs = ref_frontend.batch_graph(theirs, 4)
    a = codo_opt(ours, cache=None)
    b = ref_codo_opt(theirs, cache=None)
    plan = route_plan(a.graph, a.buffer_plan.impl)
    assert plan == ref_route_plan(b.graph, b.buffer_plan.impl)
    if forced and name == "gpt2_block":
        # The FFN's chain has no 3-D match: the batched block routes
        # attention alone, where the per-request block routes both.
        assert [g["kernel"] for g in plan] == ["pallas:flashattn.mha"]


def test_both_runtimes_serve_the_same_answers():
    """Four seeded requests through both packages' runtimes, coalesced
    into one batched gpt2_block dispatch on each side, with the same
    distinct seeded weights: the answers agree within the band of the
    transcendental op kinds (``tests/test_torch_ops.py``)."""
    from repro.core.cache import CompileCache as RefCache
    from repro.serving import ServeConfig as RefConfig
    from repro.serving import ServingRuntime as RefRuntime
    shape = (16, 64)
    ours = codo_torch.compile(dm.gpt2_block_fn, shape, device=CPU,
                              cache=CompileCache())
    theirs = codo.compile(ref_dm.gpt2_block_fn, shape, cache=RefCache())
    rng = np.random.default_rng(0)
    ws = {b.name: (rng.standard_normal(b.shape) / np.sqrt(b.shape[0])
                   ).astype(np.float32) for b in ours.graph.weights()}
    ours.bind(**ws)
    theirs.bind(**ws)
    xs = _inputs(4, shape, seed=21)
    outs = {}
    for key, rt, prog in (
            ("ours", ServingRuntime(ServeConfig(batch_window_ms=500,
                                                max_batch=4),
                                    cache=CompileCache(), device=CPU), ours),
            ("theirs", RefRuntime(RefConfig(batch_window_ms=500, max_batch=4),
                                  cache=RefCache()), theirs)):
        with rt:
            rt.add_model("m", prog)
            rt.pause()
            futs = [rt.submit("m", x=x) for x in xs]
            rt.resume()
            outs[key] = [f.result(timeout=TIMEOUT) for f in futs]
        assert rt.stats.batched_requests == 4
    name = ours.output_names[0]
    for got, want in zip(outs["ours"], outs["theirs"]):
        assert isinstance(got[name], torch.Tensor)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=2e-6)


def test_cuda_gate_declines_the_batched_attention(monkeypatch):
    """Planning only: at GPT-2-medium width the batched block's attention
    still matches on the ``cuda`` backend, and the fitted gate declines it
    as it declines the unbatched block's (flash lost to the generic path
    on the card, PERF.md §6)."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    c = codo_opt(frontend.batch_graph(dm.gpt2_block(128, 1024), 8),
                 cache=None)
    plan = route_plan(c.graph, c.buffer_plan.impl)
    assert [g["kernel"] for g in plan] == ["xla-fused"]
    assert [(r["kernel"], r["decision"]) for g in plan
            for r in g["rejected"]] == [("flashattn.mha", "predicted-loss")]
