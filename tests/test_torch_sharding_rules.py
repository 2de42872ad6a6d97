"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's ``repro.distributed.sharding``: the spec sanitizer's
strict and lenient contracts, the parameter rule table over every
architecture in ``configs/``, the batch and cache rules, and
``shard_hint``.  The port's ``P`` is a plain tuple; the reference's
``PartitionSpec`` is compared converted to tuples."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

torch = pytest.importorskip("torch")

from repro.configs import CONFIGS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import (BATCH, P,  # noqa: E402
                                              ShardingSpecError, batch_specs,
                                              cache_specs, param_specs,
                                              sanitize_spec, shard_hint)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 4, "model": 2})
MESH16 = FakeMesh({"data": 16, "model": 16})


def sds(*shape):
    return jax.ShapeDtypeStruct(tuple(shape), np.float32)


def _tuples(tree):
    """A spec tree (dicts of ``PartitionSpec`` or ``P``) as plain
    tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    assert isinstance(tree, (RefP, P)), type(tree)
    return tuple(tree)


def test_p_is_a_tuple_of_entries():
    assert P("data", None) == ("data", None)
    assert tuple(P(("pod", "data"), "model")) == tuple(
        RefP(("pod", "data"), "model"))
    assert P() == () and repr(P("data")) == "P('data')"
    assert BATCH == ref.BATCH


# --------------------------------------------------------------------------
# sanitize_spec: the reference's cases, and equal answers
# --------------------------------------------------------------------------


def test_strict_rejects_undivisible_unknown_and_names_the_path():
    with pytest.raises(ShardingSpecError, match="does not divide"):
        sanitize_spec(P("model"), (7,), MESH)
    with pytest.raises(ShardingSpecError, match="embed/tok"):
        sanitize_spec(P("model"), (7,), MESH, path="embed/tok")
    with pytest.raises(ShardingSpecError, match="only has axes"):
        sanitize_spec(P("pod"), (8,), MESH)
    for strict in (True, False):
        with pytest.raises(ShardingSpecError, match="rank"):
            sanitize_spec(P("data", None, None), (8, 8), MESH, strict=strict)
    assert sanitize_spec(P("data", "model"), (8, 8), MESH) == P("data",
                                                                "model")


@pytest.mark.parametrize("spec, shape, axes", [
    (("data", "model"), (8, 7), {"data": 4, "model": 2}),
    (("pod", "model"), (8, 8), {"data": 4, "model": 2}),
    ((("pod", "data"),), (8,), {"pod": 2, "data": 4}),
    ((("pod", "data"),), (2,), {"pod": 2, "data": 4}),
    (("data",), (1,), {"data": 16, "model": 16}),
    ((None, None), (3, 5), {"data": 4, "model": 2}),
])
def test_lenient_keeps_what_the_reference_keeps(spec, shape, axes):
    mesh = FakeMesh(axes)
    got = sanitize_spec(P(*spec), shape, mesh, strict=False)
    want = ref.sanitize_spec(RefP(*spec), shape, mesh, strict=False)
    assert tuple(got) == tuple(want)


# --------------------------------------------------------------------------
# param_specs over every architecture, batch and cache rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_param_specs_equal_the_reference_for_every_arch(arch):
    shapes = tf.param_shapes(ref_get_config(arch))
    want = _tuples(ref.param_specs(shapes, MESH16, ref_get_config(arch)))
    assert _tuples(param_specs(shapes, MESH16, get_config(arch))) == want


def test_param_specs_read_the_ports_mesh():
    cfg = get_config("gemma-7b")
    shapes = tf.param_shapes(ref_get_config("gemma-7b"))
    mesh = make_debug_mesh((16, 16), ("data", "model"), device="cpu")
    assert param_specs(shapes, mesh, cfg) == param_specs(shapes, MESH16, cfg)


def test_param_specs_strict_and_lenient():
    cfg = get_config("gpt2-medium").smoke()
    tree = {"embed": {"tok": sds(7, 64)}}   # 7 not divisible by model=2
    assert param_specs(tree, MESH, cfg)["embed"]["tok"] == P(None, "data")
    with pytest.raises(ShardingSpecError, match="embed/tok"):
        param_specs(tree, MESH, cfg, strict=True)
    group = {"groups": {"b0_attn": {
        "wq": {"w": sds(2, 64, 64)}, "wo": {"w": sds(2, 64, 64)},
        "mlp": {"w_in": {"w": sds(2, 64, 128)},
                "w_out": {"w": sds(2, 128, 64)}}}}}
    g = param_specs(group, MESH, cfg)["groups"]["b0_attn"]
    assert g["wq"]["w"] == P(None, "data", "model")
    assert g["wo"]["w"] == P(None, "model", "data")
    assert g["mlp"]["w_out"]["w"] == P(None, "model", "data")


def test_batch_specs_equal_the_reference():
    batch = {"tokens": sds(8, 16), "scalar": sds(), "odd": sds(3, 4)}
    for mesh in (MESH, FakeMesh({"pod": 2, "data": 4, "model": 2})):
        assert _tuples(batch_specs(batch, mesh)) == _tuples(
            ref.batch_specs(batch, mesh))
    assert batch_specs(batch, MESH)["tokens"] == P("data", None)


@pytest.mark.parametrize("arch", ["gpt2-medium", "recurrentgemma-9b",
                                  "mamba2-780m", "whisper-large-v3"])
def test_cache_specs_equal_the_reference(arch):
    cfg = ref_get_config(arch).smoke()
    cache = jax.eval_shape(lambda: tf.init_cache(cfg, 4, 32))
    want = _tuples(ref.cache_specs(cache, MESH, cfg))
    assert _tuples(cache_specs(cache, MESH, get_config(arch).smoke())) == want


def test_cache_specs_head_divisibility_switch():
    cfg = get_config("gpt2-medium").smoke()
    ok = {"groups": {"b0_attn": {"k": sds(2, 8, 32, 2, 16)}}}
    odd = {"groups": {"b0_attn": {"k": sds(2, 8, 32, 3, 16)}}}
    assert cache_specs(ok, MESH, cfg)["groups"]["b0_attn"]["k"] == P(
        None, "data", None, "model", None)
    assert cache_specs(odd, MESH, cfg)["groups"]["b0_attn"]["k"] == P(
        None, "data", "model", None, None)


def test_shard_hint_is_identity():
    x = torch.ones(4, 4)
    assert shard_hint(x, "data", None) is x
    y = np.ones((4, 4), np.float32)
    assert shard_hint(y, ("pod", "data")) is y is ref.shard_hint(y, "data")
