"""Measured autotuning in the port on the CPU: ``autotune_compiled``, the
``autotune`` methods of a program and a train step, ``compile(...,
autotune=True)``, the tuning database's place in the lowering memo key,
a tuning record travelling in an artifact into a fresh interpreter, and a
reference ``TuningRecord`` document crossing into the port's database and
back unchanged.

The times measured here are CPU walls of the kernels' plain versions:
they exercise the mechanism, not the card (``chip_smoke.py`` measures
there).  Every test leaves the process tuning database empty, since a
record in it beats the cost gate in any later test of the worker.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo_torch  # noqa: E402
from repro.core import CodoOptions as RefOptions  # noqa: E402
from repro.core import codo_opt as ref_codo_opt  # noqa: E402
from repro.core.tuning import TuningDB as RefDB  # noqa: E402
from repro.core.tuning import autotune_compiled as ref_autotune  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import routing, tuning  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.core.lowering import (LOWER_CACHE_STATS,  # noqa: E402
                                       clear_lower_cache)
from repro_torch.core.tuning import (TuningDB, TuningRecord,  # noqa: E402
                                     autotune_compiled, default_tuning_db)
from repro_torch.models import dataflow_models as dm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FAST = dict(repeats=2, warmup=1)
GPT2 = ("flashattn.mha", "streamfuse.mmchain")


@pytest.fixture(autouse=True)
def _empty_default_db(monkeypatch):
    monkeypatch.delenv("CODO_TUNING_DB", raising=False)
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    tuning.reset_default_tuning_db()
    yield
    tuning.reset_default_tuning_db()


def _decisions(program) -> dict:
    """pattern -> decision of every matched chain of the lowered program."""
    return {r.kernel: r.decision for g in program.lower().groups
            for r in (*g.routes, *g.rejected)}


def _check_records(records, patterns):
    assert [r.pattern for r in records] == list(patterns)
    for r in records:
        assert isinstance(r, TuningRecord)
        assert (r.backend, r.hw, r.tile) == ("cpu", "tpu-v5e", None)
        assert r.routed_ms > 0 and r.generic_ms > 0
        assert r.choice == ("pallas" if r.routed_ms <= r.generic_ms
                            else routing.XLA_FUSED)


def test_program_autotune_records_and_reroutes():
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    assert set(_decisions(program).values()) == {"predicted-loss"}
    records = program.autotune(**FAST)
    _check_records(records, GPT2)
    assert len(default_tuning_db()) == 2
    got = _decisions(program)
    for r in records:
        assert got[r.pattern] == ("tuned" if r.choice == "pallas"
                                  else "tuned-generic")
    routed = {r.kernel for g in program.lower().groups for r in g.routes}
    assert routed == {r.pattern for r in records if r.choice == "pallas"}


def test_train_step_autotune_covers_all_three_phases():
    step = codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                              grad=True, device="cpu")
    records = step.autotune(**FAST)
    # The forward's chains are not exclusive (residuals), the update has
    # none: the backward's two mmgrad chains are the records.
    _check_records(records, ["streamfuse.mmgrad"] * 2)
    assert {r.workload for r in records} == {step.backward.graph.name}
    assert set(_decisions(step.backward).values()) <= {"tuned",
                                                        "tuned-generic"}
    rng = np.random.default_rng(0)
    x, target = (rng.standard_normal((8, 16)).astype(np.float32)
                 for _ in range(2))
    loss, grads = step.value_and_grad(x, target)
    assert torch.isfinite(loss).all()
    assert sorted(grads) == sorted(step.param_names)


@pytest.mark.parametrize("grad", [False, True], ids=["program", "train_step"])
def test_compile_autotune_true_tunes_before_returning(grad):
    if grad:
        out = codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                                 grad=True, device="cpu", autotune=True)
        program, want = out.backward, 2
    else:
        program = codo_torch.compile(dm.gpt2_block_fn, (16, 64),
                                     device="cpu", autotune=True)
        want = 2
    assert len(default_tuning_db()) == want
    assert set(_decisions(program).values()) <= {"tuned", "tuned-generic"}


def test_memo_key_flips_when_the_db_changes():
    clear_lower_cache()
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    key0 = routing.routing_state_key("cpu")
    first = program.lower()
    assert LOWER_CACHE_STATS["misses"] == 1
    program.autotune(**FAST)
    key1 = routing.routing_state_key("cpu")
    assert key1 != key0 and key1[-1] == default_tuning_db().digest()
    again = program.lower()
    assert again is not first and LOWER_CACHE_STATS["misses"] == 2
    # A record changed in place changes the key again.
    rec = next(iter(default_tuning_db().entries.values()))
    flipped = TuningRecord.from_dict({**rec.to_dict(), "choice": "pallas"
                                      if rec.choice != "pallas"
                                      else routing.XLA_FUSED})
    default_tuning_db().update(flipped)
    assert routing.routing_state_key("cpu") not in (key0, key1)


def test_private_db_collects_without_rerouting():
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    db = TuningDB()
    records = program.autotune(db=db, **FAST)
    assert len(db) == len(records) == 2
    assert len(default_tuning_db()) == 0
    assert set(_decisions(program).values()) == {"predicted-loss"}


def test_forced_routing_still_routes_under_an_empty_default_db(monkeypatch):
    """A measurement in the default database beats ``CODO_FORCE_PALLAS``
    (``decide_route``), so a measuring run that must keep launching every
    kernel tunes into a private database; with the default one empty,
    forcing routes every match."""
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    program.autotune(db=TuningDB(), **FAST)
    assert len(default_tuning_db()) == 0
    assert _decisions(program) == {p: "forced" for p in GPT2}
    assert [g.kernel for g in program.lower().groups] == [
        "pallas:flashattn.mha+streamfuse.mmchain"]
    # Whereas a default-database record overrides the force.
    program.autotune(**FAST)
    assert set(_decisions(program).values()) <= {"tuned", "tuned-generic"}


def test_autotune_times_the_same_chains_as_the_reference():
    """Both packages' sweeps key the same chains: same signatures, patterns
    and tasks, in the same order, for the GPT-2 block."""
    ours = autotune_compiled(codo_opt(dm.gpt2_block(16, 64), cache=None),
                             device="cpu", db=TuningDB(), **FAST)
    theirs = ref_autotune(ref_codo_opt(ref_dm.gpt2_block(16, 64), cache=None),
                          db=RefDB(), **FAST)
    assert [(r.signature, r.pattern, r.tasks, r.hw, r.workload)
            for r in ours] == [(r.signature, r.pattern, r.tasks, r.hw,
                                r.workload) for r in theirs]


def test_autotune_compiled_with_no_device_needs_a_card(monkeypatch):
    """Like every entry point of the port, ``autotune_compiled`` measures
    on the card unless the caller asks for the CPU: with no card it
    raises, and times nothing on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = TuningDB()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune_compiled(codo_opt(dm.feed_forward(16, 32), cache=None),
                          db=db, **FAST)
    assert len(db) == 0


def test_reference_records_cross_into_the_port_db_unchanged():
    c = ref_codo_opt(ref_dm.feed_forward(16, 32),
                     RefOptions.preset("opt5", budget_units=64), cache=None)
    ref_db = RefDB()
    assert ref_autotune(c, db=ref_db, **FAST)
    doc = json.loads(json.dumps(ref_db.to_dict()))
    db = TuningDB.from_dict(doc)
    assert db.to_dict() == ref_db.to_dict() == doc
    assert db.digest() == ref_db.digest()
    assert set(db.entries) == set(ref_db.entries)
    # A record keyed by the reference routes the port's same-shaped chain.
    ours = codo_opt(dm.feed_forward(16, 32), cache=None)
    sig = {r.signature for r in db.entries.values()}
    impl = ours.buffer_plan.impl
    mine = {tuning.chain_signature(ours.graph, tasks)
            for names in routing.fifo_groups(ours.graph, impl)
            for _p, tasks in routing.match_group(ours.graph, names, impl)}
    assert sig == mine


def test_tuning_roundtrips_through_artifact_in_fresh_interpreter(tmp_path):
    program = codo_torch.compile(dm.feed_forward_fn, (16, 32), device="cpu")
    records = program.autotune(**FAST)
    assert records and len(default_tuning_db()) >= 1
    doc = program.export()
    assert doc["schema_version"] == "1.5"
    assert len(doc["tuning"]["entries"]) == len(records)
    path = tmp_path / "ff.json"
    path.write_text(json.dumps(doc))

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for k in ("CODO_TUNING_DB", "CODO_FORCE_PALLAS", "CODO_DISABLE_PALLAS",
              "CODO_BACKEND"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(f"""
        import codo_torch
        from repro_torch.core.tuning import default_tuning_db
        from repro_torch.models.dataflow_models import random_inputs

        assert len(default_tuning_db()) == 0
        p = codo_torch.load({str(path)!r}, device="cpu")
        want = {sorted(r.signature for r in records)!r}
        got = sorted(r.signature for r in default_tuning_db().entries.values())
        assert got == want, (got, want)
        # the imported measurement drives routing in this process too
        decisions = {{r.decision for g in p.lower().groups
                      for r in (*g.routes, *g.rejected)}}
        assert decisions <= {{"tuned", "tuned-generic"}}, decisions
        p(**{{n: random_inputs(p.graph)[n] for n in p.input_names}})
        print("ROUNDTRIP-OK", len(default_tuning_db()))
    """)], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ROUNDTRIP-OK" in proc.stdout


def test_random_env_lies_on_the_programs_device():
    g = codo_opt(dm.gpt2_block(16, 64), cache=None).graph
    env = tuning._random_env(g, torch.device("cpu"), seed=3)
    names = {b.name for b in g.buffers.values()
             if b.kind in ("input", "weight")}
    assert set(env) == names
    for name, t in env.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == tuple(g.buffers[name].shape)
    again = tuning._random_env(g, torch.device("cpu"), seed=3)
    assert all(torch.equal(env[k], again[k]) for k in env)
    np.testing.assert_array_equal(
        env["x"].numpy(),
        np.random.default_rng(3).standard_normal((16, 64)).astype(np.float32))
