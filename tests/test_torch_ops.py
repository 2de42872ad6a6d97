"""The port's op registry against the reference's jnp bodies.

Same seeded numpy inputs through both registries, which hold the same 47
kinds.  Indexing and exact arithmetic (identity, dup, transpose, bcast,
add, vadd, affine, scale, mul, divc, rdivc, div, relu, relu_grad, pad2d,
the zeros/fill_interior pair, maxpool2d, reshape, const, concat, split,
slice, and the gradient kinds outer, slice_grad, mean_grad and
maxpool2d_grad) must match bit for bit; gelu, softmax, matmul, mv, mean,
the reductions, the two scan gradients and the other gradient and
optimizer kinds within rtol 1e-6 / atol 2e-6 (torch and XLA:CPU evaluate
tanh, exp, pow and the sums in another order: about 1e-6 apart on
unit-scale inputs); conv2d and its two gradients within rtol 1e-5 /
atol 1e-5 (sums of up to 72 products in another order, outputs up to
about 30).  A kind neither registry holds must say so.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import frontend as ref_F  # noqa: E402
from repro.core import ops as ref_ops  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core import ops  # noqa: E402

# The update graph's optimizer attributes (the reference's defaults).
ADAM = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "wd": 0.1}
SCHED = {"lr": 3e-4, "warmup_steps": 100, "total_steps": 10000,
         "min_lr_frac": 0.1}
BAND = dict(rtol=1e-6, atol=2e-6)
CONV_BAND = dict(rtol=1e-5, atol=1e-5)


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
    "vadd_sub": (ops.OpSpec("vadd", ("a", "b"), ("y",),
                            {"alpha": 1.0, "beta": -1.0}), [(6, 5), (6, 5)]),
    "vadd_scaled": (ops.OpSpec("vadd", ("a", "b"), ("y",),
                               {"alpha": 0.5, "beta": 2.0}), [(6, 5), (6, 5)]),
    "mul": (ops.OpSpec("mul", ("a", "b"), ("y",)), [(6, 5), (6, 5)]),
    "affine_neg": (ops.OpSpec("affine", ("x",), ("y",), {"a": -1.0, "b": 2.5}),
                   [(6, 5)]),
    "affine_pos": (ops.OpSpec("affine", ("x",), ("y",), {"a": 1.0, "b": 1.0}),
                   [(6, 5)]),
    "affine_any": (ops.OpSpec("affine", ("x",), ("y",), {"a": 0.3, "b": -1.0}),
                   [(6, 5)]),
    "divc": (ops.OpSpec("divc", ("x",), ("y",), {"c": 3.0}), [(6, 5)]),
    "divc_count": (ops.OpSpec("divc", ("x",), ("y",), {"c": 2048.0}),
                   [(1, 1)]),
    "bcast": (ops.OpSpec("bcast", ("x",), ("y",), {"shape": (6, 5)}),
              [(1, 1)]),
    "relu_grad": (ops.OpSpec("relu_grad", ("g", "x"), ("y",)),
                  [(6, 5), (6, 5)]),
    "relu": (ops.OpSpec("relu", ("x",), ("y",)), [(2, 3, 6, 5)]),
    "rdivc": (ops.OpSpec("rdivc", ("x",), ("y",), {"c": 3.0}), [(6, 5)]),
    "div": (ops.OpSpec("div", ("a", "b"), ("y",)), [(6, 5), (6, 5)]),
    "pad2d": (ops.OpSpec("pad2d", ("x",), ("y",), {"pad": 2}),
              [(2, 3, 5, 4)]),
    "zeros": (ops.OpSpec("zeros", (), ("y",), {"shape": (2, 3, 4, 4),
                                                "dtype": "float32"}), []),
    "fill_interior": (ops.OpSpec("fill_interior", ("x",), ("y",),
                                 {"pad": 1}), [(2, 3, 5, 4)]),
    # the Fig. 4b init/fill pair after the coarse pass fused its producers
    "pad_pair": (ops.OpSpec("fused", ("x",), ("p",), parts=(
        ops.OpSpec("zeros", (), ("p",), {"shape": (1, 2, 9, 8),
                                          "dtype": "float32"}),
        ops.OpSpec("fill_interior", ("x",), ("p",), {"pad": 2}))),
        [(1, 2, 5, 4)]),
    "maxpool2d": (ops.OpSpec("maxpool2d", ("x",), ("y",), {"k": 2}),
                  [(2, 3, 8, 6)]),
    "maxpool2d_ragged": (ops.OpSpec("maxpool2d", ("x",), ("y",), {"k": 2}),
                         [(1, 2, 7, 5)]),
    "reshape": (ops.OpSpec("reshape", ("x",), ("y",), {"shape": (2, -1)}),
                [(2, 3, 4, 4)]),
    "const": (ops.OpSpec("const", (), ("y",), {
        "value": ((1.5, -2.0, 0.25), (3.0, 0.1, -7.0)),
        "dtype": "float32"}), []),
    "concat": (ops.OpSpec("concat", ("a", "b", "c"), ("y",), {"axis": 1}),
               [(4, 3), (4, 5), (4, 1)]),
    "split": (ops.OpSpec("split", ("x",), ("y0", "y1", "y2"),
                         {"axis": 1, "sizes": (3, 5, 1)}), [(4, 9)]),
    "slice": (ops.OpSpec("slice", ("x",), ("y",), {
        "starts": (1, 0, 2), "sizes": (2, 3, 3)}), [(4, 3, 6)]),
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
    "mean_all": (ops.OpSpec("mean_all", ("x",), ("y",)), [(32, 64)]),
    "gelu_grad": (ops.OpSpec("gelu_grad", ("g", "x"), ("y",)),
                  [(64, 48), (64, 48)]),
    "softmax_grad": (ops.OpSpec("softmax_grad", ("g", "y"), ("o",),
                                {"axis": -1}), [(32, 40), (32, 40)]),
    "softmax_grad_axis0": (ops.OpSpec("softmax_grad", ("g", "y"), ("o",),
                                      {"axis": 0}), [(32, 40), (32, 40)]),
    "sumsq": (ops.OpSpec("sumsq", ("x",), ("y",)), [(64, 48)]),
    "fused": (ops.OpSpec("fused", parts=(
        ops.OpSpec("scale", ("x",), ("h",), {"s": 2.0}),
        ops.OpSpec("gelu", ("h",), ("y",)))), [(16, 32)]),
    "mv": (ops.OpSpec("mv", ("A", "x"), ("y",)), [(48, 40), (40,)]),
    "mv_trans": (ops.OpSpec("mv", ("A", "x"), ("y",), {"trans": True}),
                 [(48, 40), (48,)]),
    "mean": (ops.OpSpec("mean", ("x",), ("y",), {"axes": (2, 3)}),
             [(2, 16, 7, 7)]),
}

# conv2d: the reference's jax.lax.conv_general_dilated against the port's
# body (full float32), VALID on an already padded input.
CONV = {
    "conv2d": (ops.OpSpec("conv2d", ("x", "w"), ("y",),
                          {"stride": 1, "groups": 1}),
               [(2, 8, 10, 9), (6, 8, 3, 3)]),
    "conv2d_stride2": (ops.OpSpec("conv2d", ("x", "w"), ("y",),
                                  {"stride": 2, "groups": 1}),
                       [(1, 3, 15, 15), (8, 3, 7, 7)]),
    "conv2d_1x1": (ops.OpSpec("conv2d", ("x", "w"), ("y",),
                              {"stride": 1, "groups": 1}),
                   [(1, 16, 6, 6), (12, 16, 1, 1)]),
    "conv2d_depthwise": (ops.OpSpec("conv2d", ("x", "w"), ("y",),
                                    {"stride": 2, "groups": 8}),
                         [(1, 8, 9, 9), (8, 1, 3, 3)]),
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


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv2d_within_band(case):
    spec, shapes = CONV[case]
    got, want = _both(spec, [_rand(*s, seed=i) for i, s in enumerate(shapes)])
    assert got["y"].shape == want["y"].shape
    np.testing.assert_allclose(got["y"], want["y"], **CONV_BAND)


def test_registry_holds_exactly_the_ported_kinds():
    assert ops.registered_ops() == ref_ops.registered_ops()
    assert len(ops.registered_ops()) == 47


@pytest.mark.parametrize("kind", ["no_such_grad"])
def test_unported_kind_raises_naming_it(kind):
    assert kind not in ref_ops.registered_ops()
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


def _scalar(v):
    return np.full((1, 1), v, np.float32)


# (spec, inputs) of the update graph's kinds at the values a train step
# gives them: the step counter before, at and past warmup, a gradient
# norm above and below the clip, moments at several steps.
OPTIMIZER = {
    **{f"lr_sched_step{n}": (ops.OpSpec("lr_sched", ("s",), ("lr",), SCHED),
                             [_scalar(n)])
       for n in (1, 3, 99, 100, 500, 9999, 20000)},
    "clip_scale_clipped": (ops.OpSpec("clip_scale", ("ss",), ("sc", "n"),
                                      {"max_norm": 1.0}), [_scalar(16.7)]),
    "clip_scale_under": (ops.OpSpec("clip_scale", ("ss",), ("sc", "n"),
                                    {"max_norm": 1.0}), [_scalar(0.25)]),
    "clip_scale_zero": (ops.OpSpec("clip_scale", ("ss",), ("sc", "n"),
                                   {"max_norm": 1.0}), [_scalar(0.0)]),
    **{f"adamw_step{n}": (ops.OpSpec(
        "adamw_step", ("p", "g", "m", "v", "sc", "lr", "s"),
        ("p2", "m2", "v2"), ADAM),
        [_rand(16, 24, seed=1) * 0.1, _rand(16, 24, seed=2),
         _rand(16, 24, seed=3) * 0.01, np.abs(_rand(16, 24, seed=4)) * 1e-4,
         _scalar(0.4), _scalar(3e-4 * (n + 1) / 100), _scalar(n)])
       for n in (1, 7, 500)},
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER))
def test_optimizer_kinds_within_band(case):
    spec, arrays = OPTIMIZER[case]
    got, want = _both(spec, arrays)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], **BAND)


def test_bcast_is_an_expand_view():
    x = torch.full((1, 1), 0.5)
    y = ops.materialize(ops.OpSpec("bcast", ("x",), ("y",),
                                   {"shape": (3, 4)}))({"x": x})["y"]
    assert y.shape == (3, 4) and y.stride() == (0, 0)
    assert y.data_ptr() == x.data_ptr()


def test_divc_is_true_division():
    """``x / c``, not ``x * (1 / c)``: the two differ on some inputs."""
    x = torch.from_numpy(_rand(64, 64))
    spec = ops.OpSpec("divc", ("x",), ("y",), {"c": 3.0})
    y = ops.materialize(spec)({"x": x})["y"]
    np.testing.assert_array_equal(y.numpy(), x.numpy() / np.float32(3.0))
    assert (y != x * np.float32(1 / 3)).any()


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


# --------------------------------------------------------------------------
# The gradient kinds the VJP rules emit (outer, slice_grad, mean_grad,
# maxpool2d_grad, the conv gradients, the scan gradients).
# --------------------------------------------------------------------------


def _relu_tied(*shape, seed=0):
    """relu(N(0, 1) − 0.5): about a quarter of the 2 × 2 windows are all
    zero, so the max-pool gradient's ties show."""
    return np.maximum(_rand(*shape, seed=seed) - 0.5, 0.0).astype(np.float32)


def _gates(*shape, seed=0, lo=0.5, hi=0.999):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


GRAD_EXACT = {
    "outer": (ops.OpSpec("outer", ("a", "b"), ("y",)),
              [_rand(7, seed=1), _rand(5, seed=2)]),
    "slice_grad": (ops.OpSpec("slice_grad", ("g",), ("y",), {
        "starts": (1, 0, 2), "sizes": (2, 3, 3), "x_shape": (4, 3, 6)}),
        [_rand(2, 3, 3)]),
    "slice_grad_pad_window": (ops.OpSpec("slice_grad", ("g",), ("y",), {
        "starts": (0, 0, 1, 1), "sizes": (2, 3, 5, 4),
        "x_shape": (2, 3, 7, 6)}), [_rand(2, 3, 5, 4)]),
    "mean_grad_spatial": (ops.OpSpec("mean_grad", ("g",), ("y",), {
        "axes": (2, 3), "x_shape": (2, 5, 7, 7)}), [_rand(2, 5)]),
    "mean_grad_unsorted": (ops.OpSpec("mean_grad", ("g",), ("y",), {
        "axes": (2, 0), "x_shape": (3, 4, 6)}), [_rand(4)]),
    "maxpool2d_grad": (ops.OpSpec("maxpool2d_grad", ("g", "x"), ("y",),
                                  {"k": 2}),
                       [_rand(2, 3, 4, 3, seed=1), _relu_tied(2, 3, 8, 6)]),
    "maxpool2d_grad_odd": (ops.OpSpec("maxpool2d_grad", ("g", "x"), ("y",),
                                      {"k": 2}),
                           [_rand(2, 3, 3, 4, seed=1),
                            _relu_tied(2, 3, 7, 9)]),
    "maxpool2d_grad_k3": (ops.OpSpec("maxpool2d_grad", ("g", "x"), ("y",),
                                     {"k": 3}),
                          [_rand(1, 2, 3, 2, seed=1), _relu_tied(1, 2, 10, 8)]),
}

# (spec, inputs): ``x_shape`` / ``w_shape`` at stride 1, at a ragged
# stride 2 (the last row and column unread) and with groups = C.
GRAD_CONV = {
    "input_s1": (ops.OpSpec("conv2d_input_grad", ("g", "w"), ("y",), {
        "stride": 1, "groups": 1, "x_shape": (2, 4, 8, 8)}),
        [_rand(2, 6, 6, 6), _rand(6, 4, 3, 3, seed=1)]),
    "input_s2_ragged": (ops.OpSpec("conv2d_input_grad", ("g", "w"), ("y",), {
        "stride": 2, "groups": 1, "x_shape": (2, 4, 10, 10)}),
        [_rand(2, 6, 4, 4), _rand(6, 4, 3, 3, seed=1)]),
    "input_depthwise": (ops.OpSpec("conv2d_input_grad", ("g", "w"), ("y",), {
        "stride": 2, "groups": 4, "x_shape": (2, 4, 9, 9)}),
        [_rand(2, 4, 4, 4), _rand(4, 1, 3, 3, seed=1)]),
    "input_depthwise_s1": (ops.OpSpec("conv2d_input_grad", ("g", "w"), ("y",),
                                      {"stride": 1, "groups": 4,
                                       "x_shape": (1, 4, 7, 7)}),
                           [_rand(1, 4, 5, 5), _rand(4, 1, 3, 3, seed=1)]),
    "weight_s1": (ops.OpSpec("conv2d_weight_grad", ("g", "x"), ("y",), {
        "stride": 1, "groups": 1, "w_shape": (6, 4, 3, 3)}),
        [_rand(2, 6, 6, 6), _rand(2, 4, 8, 8, seed=1)]),
    "weight_s2_ragged": (ops.OpSpec("conv2d_weight_grad", ("g", "x"), ("y",), {
        "stride": 2, "groups": 1, "w_shape": (6, 4, 3, 3)}),
        [_rand(2, 6, 4, 4), _rand(2, 4, 10, 10, seed=1)]),
    "weight_depthwise": (ops.OpSpec("conv2d_weight_grad", ("g", "x"), ("y",), {
        "stride": 2, "groups": 4, "w_shape": (4, 1, 3, 3)}),
        [_rand(2, 4, 4, 4), _rand(2, 4, 9, 9, seed=1)]),
    "weight_depthwise_s1": (ops.OpSpec("conv2d_weight_grad", ("g", "x"),
                                       ("y",), {"stride": 1, "groups": 4,
                                                "w_shape": (4, 1, 3, 3)}),
                            [_rand(1, 4, 5, 5), _rand(1, 4, 7, 7, seed=1)]),
    "weight_1x1_s2_ragged": (ops.OpSpec("conv2d_weight_grad", ("g", "x"),
                                        ("y",), {"stride": 2, "groups": 1,
                                                 "w_shape": (8, 4, 1, 1)}),
                             [_rand(1, 8, 4, 4), _rand(1, 4, 8, 8, seed=1)]),
}

GRAD_SCAN = {
    "rglru_scan_grad": (ops.OpSpec("rglru_scan_grad", ("g", "a", "b"),
                                   ("da", "db")),
                        [_rand(2, 37, 6), _gates(2, 37, 6, seed=1),
                         0.1 * _rand(2, 37, 6, seed=2)]),
    "rglru_scan_grad_one_step": (ops.OpSpec("rglru_scan_grad",
                                            ("g", "a", "b"), ("da", "db")),
                                 [_rand(3, 1, 4), _gates(3, 1, 4, seed=1),
                                  _rand(3, 1, 4, seed=2)]),
    "ssd_scan_grad": (ops.OpSpec("ssd_scan_grad", ("g", "s", "d"),
                                 ("ds", "dd")),
                      [_rand(6, 3, 4, 5), 0.1 * _rand(6, 3, 4, 5, seed=1),
                       _gates(6, 3, 1, 1, seed=2, hi=0.99)]),
}


@pytest.mark.parametrize("case", sorted(GRAD_EXACT))
def test_gradient_kinds_bit_for_bit(case):
    spec, arrays = GRAD_EXACT[case]
    got, want = _both(spec, arrays)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_maxpool_grad_cases_hold_tied_windows():
    """The relu'd inputs do hold all-zero windows, and the gradient lands
    on one element of each (the first), not on all four."""
    spec, (g, x) = GRAD_EXACT["maxpool2d_grad_odd"]
    win = x[:, :, :6, :8].reshape(2, 3, 3, 2, 4, 2).max(axis=(3, 5))
    assert (win == 0).sum() >= 4
    got, _ = _both(spec, [g, x])
    y = got["y"][:, :, :6, :8].reshape(2, 3, 3, 2, 4, 2)
    np.testing.assert_array_equal((y != 0).sum(axis=(3, 5)), g != 0)
    assert not got["y"][:, :, 6:, :].any() and not got["y"][:, :, :, 8:].any()


@pytest.mark.parametrize("case", sorted(GRAD_CONV))
def test_conv_gradients_within_band(case):
    spec, arrays = GRAD_CONV[case]
    got, want = _both(spec, arrays)
    assert got["y"].shape == want["y"].shape
    np.testing.assert_allclose(got["y"], want["y"], **CONV_BAND)


def test_ragged_stride_leaves_the_unread_edge_zero():
    spec, arrays = GRAD_CONV["input_s2_ragged"]
    got, _ = _both(spec, arrays)
    assert not got["y"][:, :, 9, :].any() and not got["y"][:, :, :, 9].any()
    assert got["y"][:, :, 8, :].any()


@pytest.mark.parametrize("case", sorted(GRAD_SCAN))
def test_scan_gradients_within_band(case):
    spec, arrays = GRAD_SCAN[case]
    got, want = _both(spec, arrays)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BAND)


def test_gradient_bodies_write_no_operand():
    """slice_grad embeds into a fresh tensor; mean_grad is an expand view
    of ``g / count``; neither touches its operand."""
    g = torch.from_numpy(_rand(2, 3, 3))
    before = g.clone()
    spec, _ = GRAD_EXACT["slice_grad"]
    y = ops.materialize(spec)({"g": g})["y"]
    assert y.data_ptr() != g.data_ptr()
    torch.testing.assert_close(g, before, rtol=0, atol=0)
    spec, _ = GRAD_EXACT["mean_grad_spatial"]
    y = ops.materialize(spec)({"g": torch.from_numpy(_rand(2, 5))})["y"]
    assert y.shape == (2, 5, 7, 7) and y.stride()[2:] == (0, 0)
