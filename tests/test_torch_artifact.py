"""Compiled-design artifacts across the two packages, on the CPU.

The port's ``repro_torch.core.artifact`` writes and reads the
reference's schema 1.5.  A reference export (gpt2_block at (16, 64),
ResNet-18 at 32 × 32, the gpt2_block train step) loads and runs in the
port, a port export loads and runs in ``codo.load``, and the
reference's ``diff_artifacts`` finds nothing between the two packages'
exports of one model.  Both sides route under ``CODO_FORCE_PALLAS=1``
(the reference's Pallas kernels in interpret mode, the port's plain
versions on CPU tensors), with the same distinct seeded weights.
Each design is compiled afresh (``cache=None``): a cached design shares
its diagnostics, and with them the routing an earlier lowering recorded,
which an export prefers to deriving its own.  Outputs agree within the
reference's own ``verify`` band, 1e-5, as in
``tests/test_torch_api.py``; the train step's loss and gradients at rtol
1e-4 / atol 1e-5 and its parameters at rtol 1e-6 / atol 1e-7, as in
``tests/test_torch_train.py``.  Also: v1.3 weights embedded and in a
``.npz`` sidecar, the failures the compatibility policy promises (a
content-hash mismatch, a newer major version, a corrupted document,
each naming its JSON path), a ``sharding`` document loading with its
plan and raising at load once its digest no longer matches, and
the compile cache's JSON mirror.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import codo  # noqa: E402
import codo_torch  # noqa: E402
from repro.core import artifact as ref_art  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import artifact as art  # noqa: E402
from repro_torch.core.cache import CompileCache  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402

BAND = dict(rtol=1e-5, atol=1e-5)
GRAD_BAND = dict(rtol=1e-4, atol=1e-5)
# model -> (function name, input shape, routed groups under forcing:
# below 224 ResNet-18's stem is a 3 x 3 stride-1 chain too, so six)
MODELS = {
    "gpt2_block": ("gpt2_block_fn", (16, 64),
                   ["pallas:flashattn.mha+streamfuse.mmchain"]),
    "resnet18": ("resnet18_fn", (1, 3, 32, 32), ["pallas:streamfuse.conv"] * 6),
}


@pytest.fixture(autouse=True)
def _forced(monkeypatch):
    monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    monkeypatch.setenv("CODO_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_BACKEND", raising=False)


def _weights(graph, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for b in graph.weights():
        fan_in = int(np.prod(b.shape[1:])) if len(b.shape) == 4 else b.shape[0]
        out[b.name] = (rng.standard_normal(b.shape) / np.sqrt(fan_in)
                       ).astype(np.float32)
    return out


def _pair(model):
    fn_name, shape, _ = MODELS[model]
    theirs = codo.compile(getattr(ref_dm, fn_name), shape, cache=None)
    ours = codo_torch.compile(getattr(dm, fn_name), shape, device="cpu",
                              cache=None)
    ws = _weights(ours.graph)
    theirs.bind(**ws)
    ours.bind(**ws)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    return ours, theirs, x


def _kernels(program, **kw):
    return [g.kernel for g in program.lower(**kw).groups if g.routes]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_reference_export_loads_and_runs_in_the_port(model):
    _, theirs, x = _pair(model)
    loaded = codo_torch.load(theirs.export(weights=True), device="cpu")
    assert loaded.device == torch.device("cpu")
    assert _kernels(loaded) == _kernels(theirs, jit=False) == MODELS[model][2]
    got = loaded(x)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs(x)), **BAND)
    loaded.verify(x)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_export_loads_and_runs_in_the_reference(model):
    ours, _, x = _pair(model)
    doc = ours.export(weights=True)
    assert doc["generator"] == "codo-repro-torch"
    loaded = codo.load(doc)
    assert _kernels(loaded, jit=False) == MODELS[model][2]
    np.testing.assert_allclose(np.asarray(loaded(x)), ours(x).numpy(), **BAND)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_reference_diff_finds_nothing_between_the_packages(model):
    ours, theirs, _ = _pair(model)
    a, b = theirs.export(), ours.export()
    assert b["provenance"]["origin"] == (
        f"traced:repro.models.dataflow_models.{MODELS[model][0]}")
    assert a["provenance"] == b["provenance"]
    assert ref_art.diff_artifacts(a, b) == []
    assert art.diff_artifacts(a, b) == []


def _train_pair():
    shape = (16, 64)
    theirs = codo.compile(ref_dm.gpt2_block_loss_fn, shape, shape, grad=True,
                          cache=None)
    ours = codo_torch.compile(dm.gpt2_block_loss_fn, shape, shape, grad=True,
                              device="cpu", cache=None)
    rng = np.random.default_rng(2)
    ws = _weights(ours.source, seed=3)
    x, t = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ours, theirs, ws, x, t


def _one_step(step, params, x, t):
    return step.step(params, step.init_opt_state(params), x, t)


def test_train_step_artifact_crosses_both_ways():
    ours, theirs, ws, x, t = _train_pair()
    assert ref_art.diff_artifacts(theirs.export(), ours.export()) == []
    ref_p, _, ref_m = _one_step(theirs, ws, x, t)

    # reference export -> the port
    loaded = codo_torch.load(theirs.export(weights=ws), device="cpu")
    assert loaded.param_names == ours.param_names
    assert [g.kernel for g in loaded.backward.lower().groups if g.routes] == [
        "pallas:streamfuse.mmgrad"] * 2
    init = loaded.init_params()
    assert all(init[w].device == loaded.device for w in init)
    p, _, m = _one_step(loaded, init, x, t)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               **GRAD_BAND)
    for w in ours.param_names:
        np.testing.assert_allclose(p[w].numpy(), np.asarray(ref_p[w]),
                                   rtol=1e-6, atol=1e-7, err_msg=w)

    # port export -> the reference
    tp, ts = codo_torch.train_state_from_numpy(
        ws, theirs.init_opt_state(ws), ours)
    doc = ours.export(weights=tp)
    assert doc["kind"] == "train_step"
    back = codo.load(doc)
    bp, _, bm = _one_step(back, back.init_params(), x, t)
    np.testing.assert_allclose(float(bm["loss"]), float(ref_m["loss"]),
                               **GRAD_BAND)
    for w in ours.param_names:
        np.testing.assert_allclose(np.asarray(bp[w]), np.asarray(ref_p[w]),
                                   rtol=1e-6, atol=1e-7, err_msg=w)


def test_loaded_train_step_verifies_against_its_own_oracle():
    ours, _, ws, x, t = _train_pair()
    p, _ = codo_torch.train_state_from_numpy(ws, ours.init_opt_state(), ours)
    loaded = codo_torch.load(ours.export(weights=p), device="cpu")
    report = loaded.verify(x, t)
    for name, (err, scale) in report.items():
        assert err <= 1e-4 * scale, name


@pytest.mark.parametrize("sidecar", [False, True])
def test_weights_round_trip(sidecar, tmp_path):
    ours, _, x = _pair("gpt2_block")
    path = tmp_path / "gpt2.json"
    doc = ours.export(path, weights=True, sidecar=sidecar)
    fmt = doc["weights"]["format"]
    assert fmt == ("sidecar" if sidecar else "embedded")
    assert (tmp_path / "gpt2.weights.npz").exists() == sidecar
    loaded = codo_torch.load(path, device="cpu")
    assert set(loaded._bindings) == {b.name for b in ours.graph.weights()}
    np.testing.assert_array_equal(loaded(x).numpy(), ours(x).numpy())
    assert loaded.export()["provenance"] == doc["provenance"]


def test_weight_hash_mismatch_fails():
    ours, _, _ = _pair("gpt2_block")
    doc = ours.export(weights=True)
    name = sorted(doc["weights"]["arrays"])[0]
    doc["weights"]["arrays"][name]["sha256"] = "0" * 64
    with pytest.raises(art.ArtifactError,
                       match=f"weights.arrays.{name}: content hash mismatch"):
        codo_torch.load(doc, device="cpu")


def test_newer_major_version_fails():
    ours, _, _ = _pair("gpt2_block")
    doc = ours.export()
    doc["schema_version"] = "2.0"
    with pytest.raises(art.ArtifactError, match="schema_version: artifact is "
                                                "v2.0"):
        codo_torch.load(doc, device="cpu")


def test_corrupted_document_fails_naming_each_path():
    ours, _, _ = _pair("gpt2_block")
    doc = json.loads(art.dumps(ours.export()))
    doc["graph"]["buffers"][0]["kind"] = "bogus"
    del doc["graph"]["tasks"][1]["loops"]
    with pytest.raises(art.ArtifactError) as err:
        codo_torch.load(doc, device="cpu")
    assert "graph.buffers[0].kind" in str(err.value)
    assert "graph.tasks[1].loops: missing required field" in str(err.value)
    with pytest.raises(art.ArtifactError, match="integrity check failed"):
        doc = ours.export()
        doc["integrity"]["structural_hash"] = "f" * 64
        art.import_artifact(doc)


def test_unknown_fields_and_newer_minor_warn():
    ours, _, x = _pair("gpt2_block")
    doc = ours.export(weights=True)
    doc["schema_version"] = "1.9"
    doc["from_the_future"] = {}
    with pytest.warns(art.ArtifactWarning) as caught:
        loaded = codo_torch.load(doc, device="cpu")
    said = " ".join(str(w.message) for w in caught)
    assert "from_the_future: unknown field" in said
    assert "v1.9 is newer than this reader" in said
    np.testing.assert_array_equal(loaded(x).numpy(), ours(x).numpy())


def test_sharding_document_raises_at_load():
    from repro.distributed.plan import MeshSpec
    theirs = codo.compile(ref_dm.gpt2_block_fn, (16, 64),
                          mesh=MeshSpec((("data", 2),)),
                          sharding_strategy="dp", cache=None)
    doc = theirs.export()
    assert doc["sharding"]["steps"]
    assert art.validate_artifact(doc) == []
    # The plan loads as it was; a section whose plan no longer matches
    # its digest raises at load.
    loaded = codo_torch.load(doc, device="cpu")
    assert loaded.sharding.digest() == theirs.sharding.digest()
    tampered = json.loads(art.dumps(doc))
    tampered["sharding"]["strategy"] = "tp"
    with pytest.raises(art.ArtifactError, match="digest mismatch"):
        codo_torch.load(tampered, device="cpu")
    bad = json.loads(art.dumps(doc))
    bad["sharding"]["steps"][0]["kind"] = "all_to_all"
    with pytest.raises(art.ArtifactError, match=r"sharding.steps\[0\].kind"):
        art.validate_artifact(bad)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_cache_mirror_writes_json_both_packages_import(how, tmp_path,
                                                       monkeypatch):
    if how == "environment":
        monkeypatch.setenv("CODO_CACHE_JSON", "1")
        cache = CompileCache(disk_dir=tmp_path)
    else:
        monkeypatch.delenv("CODO_CACHE_JSON", raising=False)
        cache = CompileCache(disk_dir=tmp_path, json_mirror=True)
    (tmp_path / "mine.json").write_text("{}")
    compiled = codo_opt(dm.gpt2_block(16, 64), cache=cache)
    key = cache.key(dm.gpt2_block(16, 64), compiled.options)
    mirror = tmp_path / f"{key}.json"
    assert mirror.exists() and cache.stats.json_mirrors == 1
    h = compiled.graph.structural_hash()
    assert art.import_artifact(mirror).graph.structural_hash() == h
    assert ref_art.import_artifact(mirror).graph.structural_hash() == h
    cache.clear(disk=True)
    assert not mirror.exists() and (tmp_path / "mine.json").exists()


def test_cache_mirror_is_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("CODO_CACHE_JSON", raising=False)
    cache = CompileCache(disk_dir=tmp_path)
    codo_opt(dm.gpt2_block(16, 64), cache=cache)
    assert not list(tmp_path.glob("*.json"))
    assert list(tmp_path.glob("*.pkl"))


def test_diff_cli_and_summary(tmp_path, capsys):
    ours, theirs, _ = _pair("gpt2_block")
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    theirs.export(a)
    ours.export(b)
    assert art.main(["diff", str(a), str(b)]) == 0
    assert "artifacts match" in capsys.readouterr().out
    other = codo_torch.compile(dm.gpt2_block_fn, (32, 64), device="cpu")
    other.export(b)
    assert art.main(["diff", str(a), str(b)]) == 1
    assert "different source" in capsys.readouterr().out
    assert art.main(["summary", str(b)]) == 0
    assert "pallas-routed" in capsys.readouterr().out


def test_load_needs_a_card_by_default(monkeypatch):
    ours, _, _ = _pair("gpt2_block")
    doc = ours.export()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            codo_torch.load(doc)


def test_routing_is_recorded_and_checked_for_the_programs_backend(
        monkeypatch):
    """An unlowered design records the routing its device's gate decides
    (the fitted ``cuda`` gate routes gpt2's two backward mmgrad chains
    at D=1024, the CPU gate neither), and an import checks the record
    against the loading program's backend: no drift warning on the card,
    a warning where the CPU gate would route otherwise."""
    from repro_torch.core.autodiff import build_train_graphs
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    graphs = build_train_graphs(dm.trace(dm.gpt2_block_loss_fn, (128, 1024),
                                         (128, 1024), name="gpt2_loss"))
    compiled = codo_opt(graphs.backward, cache=None)
    cuda = art.export_artifact(compiled, backend="cuda")["fusion"]["kernels"]
    cpu = art.export_artifact(compiled, backend="cpu")["fusion"]["kernels"]
    assert [k for k in cuda if k != "xla-fused"] == [
        "pallas:streamfuse.mmgrad"] * 2
    assert set(cpu) == {"xla-fused"}
    doc = art.export_artifact(compiled, backend="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        art.import_artifact(doc, backend="cuda")
    with pytest.warns(art.ArtifactWarning, match="fusion.kernels drift"):
        art.import_artifact(doc, backend="cpu")
