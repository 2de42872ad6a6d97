"""``codo_torch.compile`` end to end on the CPU against ``codo.compile``.

The same distinct seeded weights are bound in both packages (the
shape-keyed ``weight_init`` would make wq, wk, wv and wproj equal and hide
a swapped operand), and the outputs must agree within the reference's
own ``verify`` band, 1e-5, on the generic path and with both kernel
chains routed.  Also: the port's own ``verify``, device resolution, the
sharding entry points (``compile(mesh=)``, ``shard``, a sharded ``load``
and ``export``), ``serve --arch`` through the serving CLI, and the rule
that the port imports neither jax nor the JAX package.  The train step (``grad=True``) is held against
the reference in ``tests/test_torch_train.py``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core.lowering import lower, verify_routing  # noqa: E402
from repro_torch.kernels.flashattn import LIBRARY as FLASH_LIB  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BAND = dict(rtol=1e-5, atol=1e-5)


def _fan_in(shape):
    """Rows of an (in, out) matrix; C·K·K of an OIHW conv kernel."""
    return int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]


def _weights(graph, seed=0):
    """Distinct seeded weights over the square root of their fan-in, so
    activations stay O(1) through a deep CNN and the band measures
    rounding, not growth."""
    rng = np.random.default_rng(seed)
    return {b.name: (rng.standard_normal(b.shape) / np.sqrt(_fan_in(b.shape))
                     ).astype(np.float32) for b in graph.weights()}


def _pair(fn_name, *shapes, seed=0):
    ours = codo_torch.compile(getattr(dm, fn_name), *shapes, device="cpu")
    theirs = codo.compile(getattr(ref_dm, fn_name), *shapes)
    ws = _weights(ours.graph, seed)
    assert len({w.tobytes() for w in ws.values()}) == len(ws)   # distinct
    ours.bind(**codo_torch.params_from_numpy(ws, ours.graph, "cpu"))
    theirs.bind(**ws)
    return ours, theirs


@pytest.mark.parametrize("forced", [False, True])
def test_gpt2_block_matches_reference(forced, monkeypatch):
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    ours, theirs = _pair("gpt2_block_fn", (16, 64))
    kernels = [g.kernel for g in ours.lower(jit=False).groups]
    assert kernels == ([g.kernel for g in theirs.lower(jit=False).groups])
    if forced:
        assert kernels == ["pallas:flashattn.mha+streamfuse.mmchain"]
    else:
        assert kernels == ["xla-fused"]
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = rng.standard_normal((16, 64)).astype(np.float32)
        got = ours(x)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(x)), **BAND)
        ours.verify(x)


def test_routed_equals_generic_on_cpu(monkeypatch):
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    p = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    p.bind(**_weights(p.graph))
    env = p.make_env(np.random.default_rng(2).standard_normal(
        (16, 64)).astype(np.float32))
    routed = verify_routing(p.compiled, env, device="cpu")
    assert routed.routed_groups
    assert FLASH_LIB._lib is None          # CPU tensors never build a kernel


@pytest.mark.parametrize("fn_name,shapes", [
    ("gemm_fn", [(24, 16), (16, 20)]),
    ("three_mm_fn", [(16, 16)] * 4),
    ("feed_forward_fn", [(16, 32)]),
    ("multi_head_attention_fn", [(24, 32)]),
    ("resnet18_fn", [(1, 3, 8, 8)]),
    ("vgg16_fn", [(1, 3, 32, 32)]),
    ("conv3_block_fn", [(1, 3, 14, 14)]),
    ("residual_block_fn", [(1, 8, 12, 12)]),
    ("dws_conv_block_fn", [(1, 8, 12, 12)]),
    ("atax_fn", [(48, 40), (40,)]),
    ("mvt_fn", [(40, 40), (40,), (40,)]),
    ("residual_mlp_fn", [(8, 32)]),
])
def test_kernel_benches_of_ported_kinds_match_reference(fn_name, shapes,
                                                        monkeypatch):
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    ours, theirs = _pair(fn_name, *shapes)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    np.testing.assert_allclose(ours(*xs).numpy(), np.asarray(theirs(*xs)),
                               **BAND)
    ours.verify(*xs)


def test_memo_key_tracks_routing_switches(monkeypatch):
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    c = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu").compiled
    generic = lower(c, device="cpu")
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    forced = lower(c, device="cpu")
    assert [g.kernel for g in generic.groups] == ["xla-fused"]
    assert forced.routed_groups and forced.fn is not generic.fn
    assert lower(c, device="cpu").fn is forced.fn          # memo hit


def test_params_from_numpy_takes_declared_dtype():
    g = dm.gpt2_block(16, 64)
    w = next(iter(g.weights()))
    got = codo_torch.params_from_numpy(
        {w.name: np.ones(w.shape, np.float64)}, g, "cpu")
    assert got[w.name].dtype == torch.float32
    assert got[w.name].device == torch.device("cpu")
    with pytest.raises(ValueError, match="shape"):
        codo_torch.params_from_numpy({w.name: np.ones((3, 3))}, g, "cpu")
    with pytest.raises(KeyError):
        codo_torch.params_from_numpy({"nope": np.ones(3)}, g, "cpu")


def test_float64_inputs_bind_at_buffer_dtype():
    p = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    x = np.random.default_rng(4).standard_normal((16, 64))    # float64
    assert p(x).dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        p(np.zeros((8, 64)))
    with pytest.raises(KeyError):
        p.bind(not_a_buffer=x)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        codo_torch.compile(dm.gpt2_block_fn, (16, 64))
    p = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    assert p.device == torch.device("cpu")


def _sharded_artifact():
    """A reference export of a sharded gpt2_block (a v1.4 ``sharding``
    section; the plan is pure data, so no devices are touched)."""
    from repro.distributed.plan import MeshSpec
    return codo.compile(ref_dm.gpt2_block_fn, (16, 64),
                        mesh=MeshSpec((("data", 2),)),
                        sharding_strategy="dp", cache=None).export()


def test_serve_arch_runs_through_the_cli(capsys):
    """LM token generation (``--arch``), the last entry point of the
    reference the port lacked, serves through the CLI."""
    from repro_torch.serving import cli
    assert cli.main(["--arch", "gpt2-medium", "--smoke", "--device", "cpu",
                     "--requests", "2", "--max-new", "3"]) == 0
    assert "2/2 finished" in capsys.readouterr().out


# The sharding entry points (ROADMAP.md Queue 1 item 6), ported.
def _mesh_spec():
    from repro_torch.distributed.plan import MeshSpec
    return MeshSpec((("data", 2),))


def test_sharded_load_restores_the_plans_digest():
    doc = _sharded_artifact()
    program = codo_torch.load(doc, device="cpu")
    assert program.sharding is not None
    assert program.sharding.digest() == doc["sharding"]["digest"]
    assert program.sharding.strategy == "dp"


def test_compile_with_a_mesh_spec_returns_a_sharded_program():
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu",
                                 mesh=_mesh_spec(), sharding_strategy="dp")
    assert program.sharding.strategy == "dp"
    assert program.sharding.mesh == _mesh_spec()
    x = np.random.default_rng(5).standard_normal((16, 64)).astype(np.float32)
    y = program(x)
    assert program.mesh.devices == (torch.device("cpu"),) * 2
    assert tuple(y.shape) == (16, 64)
    program.verify(x)


def test_grad_with_a_mesh_raises_trace_error():
    with pytest.raises(codo_torch.TraceError, match="mesh"):
        codo_torch.compile(dm.gpt2_block_loss_fn, (8, 16), (8, 16),
                           device="cpu", grad=True, mesh=_mesh_spec())


def test_a_mesh_that_is_not_one_raises_clearly():
    with pytest.raises(TypeError, match="cannot build MeshSpec from object"):
        codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu",
                           mesh=object())


def test_shard_none_reverts_to_the_single_device_program():
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu")
    x = np.random.default_rng(6).standard_normal((16, 64)).astype(np.float32)
    single = program(x)
    single_run = program.lower()
    program.shard(_mesh_spec(), "dp")
    assert program.sharding is not None and program.lower() is not single_run
    program.shard(None)
    assert program.sharding is None and program.mesh is None
    assert torch.equal(program(x), single)


def test_export_of_a_sharded_program_writes_its_section():
    program = codo_torch.compile(dm.gpt2_block_fn, (16, 64), device="cpu",
                                 mesh=_mesh_spec(), sharding_strategy="dp")
    doc = program.export()
    assert doc["schema_version"] == "1.5"
    assert doc["sharding"] == program.sharding.to_dict()
    assert doc["sharding"]["digest"] == program.sharding.digest()
    assert "devices" not in json.dumps(doc["sharding"])


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "src" / "codo_torch.py", REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro", "codo"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
