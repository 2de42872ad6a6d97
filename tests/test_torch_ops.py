"""The port's op registry against the reference's jnp bodies.

Same seeded numpy inputs through both registries.  Indexing and exact
arithmetic (identity, dup, transpose, add, scale) must match bit for bit;
gelu, softmax and matmul within rtol 1e-6 / atol 2e-6 (torch and XLA:CPU
evaluate tanh, exp and the dot in another order: about 1e-6 apart on
unit-scale inputs).  Every other kind is not ported and must say so.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import frontend as ref_F  # noqa: E402
from repro.core import ops as ref_ops  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core import ops  # noqa: E402

PORTED = ["add", "dup", "fused", "gelu", "identity", "matmul", "scale",
          "softmax", "transpose"]
BAND = dict(rtol=1e-6, atol=2e-6)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(spec, arrays):
    """Run ``spec`` through both registries on the same numpy inputs."""
    env = dict(zip(spec.ins, arrays))
    ref_spec = ref_ops.OpSpec(spec.kind, spec.ins, spec.outs,
                              dict(spec.attrs), _ref_parts(spec.parts))
    got = ops.materialize(spec)({k: torch.from_numpy(v) for k, v in env.items()})
    want = ref_ops.materialize(ref_spec)(env)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _ref_parts(parts):
    return tuple(ref_ops.OpSpec(p.kind, p.ins, p.outs, dict(p.attrs),
                                _ref_parts(p.parts)) for p in parts)


EXACT = {
    "identity": (ops.OpSpec("identity", ("x",), ("y",)), [(6, 5)]),
    "dup": (ops.OpSpec("dup", ("x",), ("y0", "y1")), [(6, 5)]),
    "transpose": (ops.OpSpec("transpose", ("x",), ("y",)), [(6, 5)]),
    "transpose_perm": (ops.OpSpec("transpose", ("x",), ("y",),
                                  {"perm": (0, 2, 1)}), [(3, 6, 5)]),
    "add": (ops.OpSpec("add", ("a", "b"), ("y",)), [(6, 5), (6, 5)]),
    "scale": (ops.OpSpec("scale", ("x",), ("y",), {"s": 0.125}), [(6, 5)]),
    "scale_odd": (ops.OpSpec("scale", ("x",), ("y",), {"s": 1 / 3}), [(6, 5)]),
}

BANDED = {
    "gelu": (ops.OpSpec("gelu", ("x",), ("y",)), [(64, 48)]),
    "softmax": (ops.OpSpec("softmax", ("x",), ("y",), {"axis": -1}),
                [(32, 40)]),
    "softmax_axis0": (ops.OpSpec("softmax", ("x",), ("y",), {"axis": 0}),
                      [(32, 40)]),
    "matmul": (ops.OpSpec("matmul", ("a", "b"), ("y",)), [(16, 64), (64, 24)]),
    "matmul_batched": (ops.OpSpec("matmul", ("a", "b"), ("y",)),
                       [(3, 8, 16), (3, 16, 8)]),
    "fused": (ops.OpSpec("fused", parts=(
        ops.OpSpec("scale", ("x",), ("h",), {"s": 2.0}),
        ops.OpSpec("gelu", ("h",), ("y",)))), [(16, 32)]),
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_kinds_bit_for_bit(case):
    spec, shapes = EXACT[case]
    got, want = _both(spec, [_rand(*s, seed=i) for i, s in enumerate(shapes)])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", sorted(BANDED))
def test_banded_kinds_within_band(case):
    spec, shapes = BANDED[case]
    if spec.kind == "fused":
        env = {"x": _rand(*shapes[0])}
        got = ops.materialize(spec)({"x": torch.from_numpy(env["x"])})
        ref = ref_ops.OpSpec("fused", parts=_ref_parts(spec.parts))
        want = ref_ops.materialize(ref)(env)
        got = {k: v.numpy() for k, v in got.items()}
        want = {k: np.asarray(v) for k, v in want.items()}
    else:
        got, want = _both(spec, [_rand(*s, seed=i)
                                 for i, s in enumerate(shapes)])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **BAND)


def test_registry_holds_exactly_the_ported_kinds():
    assert ops.registered_ops() == PORTED


@pytest.mark.parametrize("kind", ["relu", "conv2d", "mv", "vadd",
                                  "mean_all", "gelu_grad"])
def test_unported_kind_raises_naming_it(kind):
    with pytest.raises(ops.UnknownOpError, match=kind):
        ops.materialize(ops.OpSpec(kind, ("x",), ("y",)))


def test_vjp_table_carried_as_data():
    assert ops.differentiable_ops() == ref_ops.differentiable_ops()


def test_dup_and_identity_alias_without_writing():
    x = torch.from_numpy(_rand(4, 3))
    before = x.clone()
    out = ops.materialize(ops.OpSpec("dup", ("x",), ("a", "b")))({"x": x})
    assert out["a"] is x and out["b"] is x
    assert ops.materialize(ops.OpSpec("identity", ("x",), ("y",)))(
        {"x": x})["y"] is x
    torch.testing.assert_close(x, before, rtol=0, atol=0)


def test_transpose_is_a_view():
    x = torch.from_numpy(_rand(4, 3))
    y = ops.materialize(ops.OpSpec("transpose", ("x",), ("y",)))({"x": x})["y"]
    assert y.data_ptr() == x.data_ptr() and y.shape == (3, 4)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    y = ops.materialize(ops.OpSpec("gelu", ("x",), ("y",)))({"x": x})["y"]
    exact = torch.nn.functional.gelu(x)              # erf form
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    torch.testing.assert_close(y, tanh, rtol=0, atol=0)
    assert (y - exact).abs().max() > 1e-5


def test_eager_fc_moves_numpy_weight_to_operand():
    """``fc`` draws a numpy weight; it must join the tensor operand's
    device and dtype (float64 here) and give the reference's numbers."""
    x = _rand(8, 16)
    got = F.fc(torch.from_numpy(x).double(), 12)
    assert got.dtype == torch.float64
    want = np.asarray(ref_F.fc(x, 12))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_eager_block_matches_reference():
    from repro.models.dataflow_models import gpt2_block_fn as ref_fn
    from repro_torch.models.dataflow_models import gpt2_block_fn
    x = _rand(16, 64)
    got = gpt2_block_fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_fn(x)), rtol=1e-5,
                               atol=1e-5)
