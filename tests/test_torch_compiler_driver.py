"""The port's compiler checks, batch driver, CLI and ``configs/``
(``repro_torch.core.compiler``) against the reference's on the CPU.

The batteries of ``tests/test_compiler_driver.py`` (batch driver, CLI) and
``tests/test_frontend.py`` (pass budgets) run on the port, each result
held against the reference's on the same inputs: the Table VII grid of
``--all --ablations`` cell by cell (modeled cycles, speedups,
``verify_violation_free``), the arch block graphs' structural hashes, the
config registry field by field, ``--list``, and an artifact the
reference's CLI exported, imported through the port's.  The sizes are the
reference tests' (``--seq 8``, ``--budget 64``, two workers).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import (CodoOptions, CompileCache,  # noqa: E402
                              PassBudgetError, codo_opt, codo_opt_batch,
                              enforce_pass_budgets, verify_violation_free)
from repro_torch.core import compiler  # noqa: E402
from repro_torch.core.compiler import ablation_jobs  # noqa: E402
from repro_torch.core.compiler import main as compiler_main  # noqa: E402
from repro_torch.core.tuning import reset_default_tuning_db  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402

SEQ, BUDGET = 8, 64
FAMILIES = ("gpt2-medium", "mixtral-8x22b", "mamba2-780m",
            "recurrentgemma-9b", "whisper-large-v3")


def _cell(r):
    c = r.compiled
    return (c.final.total_cycles, c.baseline.total_cycles, c.speedup,
            c.fifo_fraction, verify_violation_free(c))


@pytest.fixture(scope="module")
def grids():
    """``--all --ablations`` at ``--seq 8 --budget 64`` in both packages
    (threads, no cache): cell -> (cycles, baseline, speedup, fifo,
    violations)."""
    out = {}
    for pkg in (ref_compiler, compiler):
        jobs = pkg.ablation_jobs(pkg.batch_workloads(seq=SEQ),
                                 budget_units=BUDGET)
        results = pkg.codo_opt_batch(jobs, cache=None, max_workers=1)
        assert all(r.ok for r in results), [r.error for r in results]
        out[pkg] = {(r.config, r.preset): _cell(r) for r in results}
    return out[ref_compiler], out[compiler]


@pytest.mark.parametrize("config", sorted(ref_compiler.batch_workloads()))
def test_grid_matches_the_reference(grids, config):
    ref, ours = grids
    assert set(ours) == set(ref) and len(ours) == 13 * 5
    for preset in ("opt1", "opt2", "opt3", "opt4", "opt5"):
        assert ours[(config, preset)] == ref[(config, preset)], preset
    assert ours[(config, "opt5")][4] == []          # violation-free


def test_batch_driver_grid_and_cache():
    workloads = {"gesummv": lambda: dm.gesummv(24),
                 "residual_block": lambda: dm.residual_block(1, 8, 12)}
    cache = CompileCache()
    jobs = ablation_jobs(workloads, presets=["opt1", "opt5"], budget_units=64)
    results = codo_opt_batch(jobs, cache=cache, max_workers=4)
    assert len(results) == 4
    assert all(r.ok for r in results), [r.error for r in results]
    by_cell = {(r.config, r.preset): r.compiled for r in results}
    assert by_cell[("residual_block", "opt5")].speedup > \
        by_cell[("residual_block", "opt1")].speedup
    ref = ref_compiler.codo_opt_batch(ref_compiler.ablation_jobs(
        {"gesummv": lambda: ref_dm.gesummv(24),
         "residual_block": lambda: ref_dm.residual_block(1, 8, 12)},
        presets=["opt1", "opt5"], budget_units=64), cache=None)
    assert [_cell(r) for r in results] == [_cell(r) for r in ref]
    again = codo_opt_batch(jobs, cache=cache, max_workers=4)
    assert all(r.cache_hit for r in again)
    assert all(not verify_violation_free(r.compiled)
               for r in again if r.preset == "opt5")


def test_batch_driver_process_pool(tmp_path):
    """Spawned workers: jobs pickle, results come back executable, a
    second grid is served from the shared disk tier, and the cells are
    the reference's."""
    wl = compiler.batch_workloads(seq=SEQ)
    sub = {k: wl[k] for k in ("gpt2-medium", "mamba2-780m")}
    jobs = ablation_jobs(sub, presets=["opt1", "opt5"], budget_units=64)
    cache = CompileCache(disk_dir=tmp_path / "cc")
    results = codo_opt_batch(jobs, cache=cache, max_workers=2,
                             executor="process")
    assert len(results) == 4 and all(r.ok for r in results), \
        [r.error for r in results]
    assert not any(r.cache_hit for r in results)
    assert all(t.fn is not None
               for r in results for t in r.compiled.graph.tasks)
    rwl = ref_compiler.batch_workloads(seq=SEQ)
    ref = ref_compiler.codo_opt_batch(ref_compiler.ablation_jobs(
        {k: rwl[k] for k in sub}, presets=["opt1", "opt5"], budget_units=64),
        cache=None, max_workers=1)
    assert [_cell(r) for r in results] == [_cell(r) for r in ref]
    again = codo_opt_batch(jobs, cache=CompileCache(disk_dir=tmp_path / "cc"),
                           max_workers=2, executor="process")
    assert all(r.cache_hit for r in again)


def test_batch_process_pool_rejects_unpicklable_jobs():
    jobs = ablation_jobs({"gesummv": lambda: dm.gesummv(24)},
                         presets=["opt5"], budget_units=64)
    with pytest.raises(ValueError, match="picklable"):
        codo_opt_batch(jobs * 2, cache=None, max_workers=2,
                       executor="process")


def test_lower_memoization_structural():
    from repro_torch.core import LOWER_CACHE_STATS, clear_lower_cache, lower

    def small():
        return dm.residual_block(1, 8, 12)

    clear_lower_cache()
    c1 = codo_opt(small(), cache=None)
    p1 = lower(c1, jit=False, device="cpu")
    c2 = codo_opt(small(), cache=None)
    p2 = lower(c2, jit=False, device="cpu")
    assert LOWER_CACHE_STATS["hits"] == 1
    assert p2.fn is p1.fn
    assert [t.fused_group for t in c2.graph.tasks] == \
        [t.fused_group for t in c1.graph.tasks]
    env = {k: torch.as_tensor(v)
           for k, v in dm.random_inputs(small()).items()}
    for k, v in p1(env).items():
        assert torch.equal(v, p2(env)[k])


def test_batch_driver_reports_cell_errors():
    def boom():
        raise RuntimeError("bad build")
    results = codo_opt_batch(
        ablation_jobs({"boom": boom}, presets=["opt5"]), cache=None)
    assert len(results) == 1 and not results[0].ok
    assert "bad build" in results[0].error


@pytest.mark.parametrize("name", FAMILIES)
def test_arch_block_graphs_compile_violation_free(name):
    """One config per family (dense / moe / ssm / hybrid / enc-dec): the
    reference's graph, cycles and verdict."""
    g = dm.arch_block_graph(configs.get_config(name), S=16)
    ref = ref_dm.arch_block_graph(ref_configs.get_config(name), S=16)
    g.validate()
    assert g.structural_hash() == ref.structural_hash()
    c = codo_opt(g, CodoOptions(budget_units=64), cache=None)
    rc = ref_compiler.codo_opt(ref, ref_compiler.CodoOptions(
        budget_units=64), cache=None)
    assert not verify_violation_free(c), name
    assert verify_violation_free(c) == ref_compiler.verify_violation_free(rc)
    assert c.final.total_cycles == rc.final.total_cycles
    assert c.speedup == rc.speedup >= 1.0


def test_configs_equal_the_reference():
    assert list(configs.CONFIGS) == list(ref_configs.CONFIGS)
    assert len(configs.CONFIGS) == 11
    assert configs.SHAPES == {k: configs.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in ref_configs.SHAPES.items()}
    for name, cfg in configs.CONFIGS.items():
        ref = ref_configs.CONFIGS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(cfg.smoke()) == \
            dataclasses.asdict(ref.smoke()), name
        assert (cfg.param_count(), cfg.active_param_count(), cfg.hd) == \
            (ref.param_count(), ref.active_param_count(), ref.hd), name
        assert str(cfg.tdtype) == f"torch.{np.dtype(ref.jdtype).name}"
    with pytest.raises(KeyError):
        configs.get_config("not-a-config")


def test_cli_smoke_and_second_run_hits_cache(tmp_path, capsys):
    argv = ["--configs", "gpt2-medium", "--opts", "opt1,opt2", "--seq", "8",
            "--budget", "64", "--cache-dir", str(tmp_path / "cc"),
            "--csv", str(tmp_path / "grid.csv"), "--jobs", "2"]
    assert compiler_main(argv) == 0
    out1 = capsys.readouterr().out
    assert "gpt2-medium" in out1 and "0 cache hits" in out1
    assert (tmp_path / "grid.csv").read_text().count("gpt2-medium") == 2
    assert compiler_main(argv) == 0
    out2 = capsys.readouterr().out
    assert "2 cache hits" in out2


def test_cli_list_and_bad_config(capsys):
    assert compiler_main(["--list"]) == 0
    out = capsys.readouterr().out.split()
    assert ref_compiler.main(["--list"]) == 0
    assert out == capsys.readouterr().out.split()
    assert len(out) == 13 and "resnet18" in out and "gpt2-medium" in out \
        and "gpt2_block" in out
    with pytest.raises(SystemExit):
        compiler_main(["--configs", "not-a-config"])


def test_cli_imports_an_artifact_the_reference_exported(tmp_path, capsys):
    argv = ["--configs", "gpt2-medium", "--opts", "opt5", "--seq", "8",
            "--budget", "64", "--no-cache", "--executor", "thread"]
    assert ref_compiler.main(argv + ["--export", str(tmp_path)]) == 0
    path = tmp_path / "gpt2-medium-opt5.json"
    assert json.loads(path.read_text())["schema_version"]
    capsys.readouterr()
    assert compiler_main(["--import-artifact", str(path)]) == 0
    out = capsys.readouterr().out
    assert ref_compiler.main(["--import-artifact", str(path)]) == 0
    assert out == capsys.readouterr().out       # the same report
    assert "artifact gpt2_medium" in out and "35.6x vs sequential" in out
    assert compiler_main(argv + ["--export", str(tmp_path / "ours")]) == 0
    ours = json.loads((tmp_path / "ours" / "gpt2-medium-opt5.json")
                      .read_text())
    theirs = json.loads(path.read_text())
    assert ours["graph"] == theirs["graph"]


def test_cli_profile_budgets_and_autotune_on_the_cpu(capsys):
    argv = ["--configs", "gpt2_block", "--opts", "opt5", "--seq", "8",
            "--budget", "64", "--no-cache", "--executor", "thread",
            "--profile", "--enforce-budgets", "--pass-budget",
            "schedule=1e6", "--autotune", "--device", "cpu"]
    try:
        assert compiler_main(argv) == 0
    finally:
        reset_default_tuning_db()
    out = capsys.readouterr().out
    assert "pass profile" in out and "kernel routing" in out
    assert "pass budgets: all passes within budget" in out
    assert "chains measured" in out and "on cpu" in out


# ---- pass budgets (tests/test_frontend.py's four) -------------------------


def test_pass_budget_records_and_enforcement():
    opts = CodoOptions(pass_budgets={"schedule": 1e-9})
    c = codo_opt(dm.gemm(24, 24, 24), opts, cache=None)
    viol = c.diagnostics.budget_violations()
    assert viol and "schedule" in viol[0]
    assert any(r.over_budget for r in c.diagnostics.records)
    with pytest.warns(RuntimeWarning, match="pass budget exceeded"):
        got = enforce_pass_budgets([c.diagnostics])
    assert got == viol
    with pytest.raises(PassBudgetError):
        enforce_pass_budgets([c.diagnostics], strict=True)


def test_pass_budget_within_limit_is_quiet():
    opts = CodoOptions(pass_budgets={"schedule": 1e6})
    c = codo_opt(dm.gemm(24, 24, 24), opts, cache=None)
    assert c.diagnostics.budget_violations() == []
    assert enforce_pass_budgets([c.diagnostics], strict=True) == []


def test_pass_budgets_do_not_change_cache_key():
    assert (CodoOptions(pass_budgets={"fine": 0.5}).cache_key()
            == CodoOptions().cache_key())
    assert CodoOptions(fine=False).cache_key() != CodoOptions().cache_key()
    assert CodoOptions().cache_key() == ref_compiler.CodoOptions().cache_key()


def test_pass_budgets_survive_options_roundtrip():
    opts = CodoOptions(pass_budgets={"fine": 0.5, "coarse": 0.25})
    back = CodoOptions.from_dict(opts.to_dict())
    assert back.pass_budgets == {"coarse": 0.25, "fine": 0.5}


def test_strict_cli_budget_fails(capsys):
    argv = ["--configs", "gpt2-medium", "--opts", "opt5", "--seq", "8",
            "--budget", "64", "--no-cache", "--executor", "thread",
            "--enforce-budgets", "--strict", "--pass-budget",
            "schedule=1e-9"]
    assert compiler_main(argv) == 1
    assert "STRICT" in capsys.readouterr().err
