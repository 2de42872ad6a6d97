"""The port's entry points against the JAX reference, on the CPU.

* ``python -m repro_torch.api``'s ``main``: cold then warm it prints
  ``cache_hit=False`` then ``True`` with the reference's ``key=`` and
  ``speedup=`` for the same workload; ``--export`` writes an artifact the
  reference's ``load`` reads.
* ``kernels.streamfuse.pad_conv_relu`` with either ``use_kernel`` against
  the reference's ``pad_conv_relu(use_kernel=False)``.
* The five ``examples/torch/*.py`` with ``--device cpu`` at their smallest
  setting, run side by side as subprocesses: each exits 0 and prints its
  verdict line; quickstart's traced graph has the reference's structural
  hash.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import codo  # noqa: E402
from repro import api as ref_api  # noqa: E402
from repro.kernels.streamfuse.ops import \
    pad_conv_relu as ref_pad_conv_relu  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.kernels.streamfuse import pad_conv_relu  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LINE = re.compile(r"cache_hit=(\w+) speedup=([\d.]+x) key=(\w{12})")
CONV_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_cnn.py's band


def _line(text: str) -> tuple:
    m = LINE.search(text)
    assert m, text
    return m.group(1), m.group(2), m.group(3)


@pytest.mark.parametrize("workload", ["gemm", "feed_forward", "conv3_block"])
def test_api_cli_prints_the_reference_key_and_speedup(workload, tmp_path,
                                                      capsys):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    argv = [workload, "--cache-dir", str(port_dir), "--device", "cpu"]
    assert api.main(argv) == 0
    cold = _line(capsys.readouterr().out)
    assert api.main(argv) == 0
    warm = _line(capsys.readouterr().out)
    assert ref_api.main([workload, "--cache-dir", str(ref_dir)]) == 0
    ref = _line(capsys.readouterr().out)
    assert (cold[0], warm[0], ref[0]) == ("False", "True", "False")
    assert cold[1:] == warm[1:] == ref[1:]


def test_api_cli_runs_and_verifies_on_the_cpu(capsys):
    assert api.main(["feed_forward", "--run", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "numerics verified against the oracle" in out and "on cpu" in out


def test_api_cli_export_loads_in_the_reference(tmp_path, capsys):
    path = tmp_path / "ff.json"
    assert api.main(["feed_forward", "--device", "cpu", "--export",
                     str(path)]) == 0
    assert f"artifact exported to {path}" in capsys.readouterr().out
    program = ref_api.load(str(path))
    port = api.load(str(path), device="cpu")
    assert (program.graph.structural_hash()
            == port.graph.structural_hash())


def test_api_cli_module_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", "gemm", "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert _line(out.stdout)[0] in ("False", "True")


def test_routed_chain_hands_the_kernel_row_major_operands(monkeypatch,
                                                          capsys):
    """multi_head_attention's two chains route streamfuse.mmchain under
    forced routing, one with the transpose task's kᵀ view as w2: the
    route passes row-major operands (the kernel on the card raises on a
    strided one, as it did from ``api.main`` on the H100)."""
    from repro_torch.kernels.streamfuse import ops as sf_ops
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    real, seen = sf_ops.fused_matmul_chain, []

    def row_major_only(a, w1, w2, **kw):
        seen.append(all(t.is_contiguous() for t in (a, w1, w2)))
        return real(a, w1, w2, **kw)

    monkeypatch.setattr(sf_ops, "fused_matmul_chain", row_major_only)
    assert api.main(["multi_head_attention", "--run", "--device", "cpu"]) == 0
    assert "numerics verified" in capsys.readouterr().out
    assert seen and all(seen)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_pad_conv_relu_against_the_reference(use_kernel):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 12, 10)).astype(np.float32)
    w = (rng.standard_normal((6, 4, 3, 3)) / 6).astype(np.float32)
    want = np.asarray(ref_pad_conv_relu(jnp.asarray(x), jnp.asarray(w),
                                        use_kernel=False))
    got = pad_conv_relu(torch.from_numpy(x), torch.from_numpy(w),
                        use_kernel=use_kernel)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_pad_conv_relu_raises_on_mixed_devices():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 3, 3, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        pad_conv_relu(x, w)


# --------------------------------------------------------------------------
# The examples
# --------------------------------------------------------------------------

def _env() -> dict:
    """The child's environment: the sources on its path, one CPU thread
    each (five run beside the suite's other workers)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    env["OMP_NUM_THREADS"] = "1"
    return env


# name -> (extra arguments, the verdict line it must print)
EXAMPLES = {
    "quickstart": ([], "compiled(x) == motivating(x) == oracle ✓"),
    "compile_resnet18": (["--cache-dir", "{tmp}/cache"],
                         "reloaded design executed on cpu"),
    "pipeline_parallel": ([], "pipeline vs serial max err: 0.00e+00"),
    "serve_lm": ([], "8/8 finished;"),
    "train_lm": (["--steps", "2", "--ckpt", "{tmp}/ckpt"],
                 "arch=gpt2-medium-smoke steps=2 loss"),
}


@pytest.fixture(scope="module", autouse=True)
def example_procs(tmp_path_factory):
    """Every example started at once, when the module's first test starts,
    and stopped after its last."""
    procs = {}
    for name, (args, _) in EXAMPLES.items():
        tmp = tmp_path_factory.mktemp(name)
        argv = [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
                *(a.format(tmp=tmp) for a in args), "--device", "cpu"]
        procs[name] = subprocess.Popen(argv, cwd=tmp, env=_env(),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def example_runs(example_procs):
    """{name: (exit code, output)} of every example."""
    out = {}
    for name, p in example_procs.items():
        text = p.communicate(timeout=240)[0]
        out[name] = (p.returncode, text)
    return out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_and_prints_its_verdict(example_runs, name):
    rc, text = example_runs[name]
    assert rc == 0, text[-3000:]
    assert EXAMPLES[name][1] in text, text[-3000:]


def test_quickstart_traces_the_reference_graph(example_runs):
    _, text = example_runs["quickstart"]
    m = re.search(r"structural hash (\w+)", text)
    assert m, text

    def motivating(x):
        return codo.F.conv(x, 8, 3, relu=True)

    ref = codo.compile(motivating, (1, 3, 32, 32), name="motivating")
    assert m.group(1) == ref.source.structural_hash()
