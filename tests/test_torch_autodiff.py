"""Every differentiable kind's VJP rule, the port's backward graph against
the reference's, on the CPU.

The ``CASES`` table is ``tests/test_autodiff.py``'s: one forward op a
case, its operand shapes, attributes and input domain.  Each case builds
the same one-op graph in both packages (each package's ``GB`` and
``_BwdBuilder``), differentiates it with each package's
``build_backward`` with respect to every input, and runs both backward
graphs — the port's op bodies on torch tensors, the reference's on jax
arrays — on the same seeded numpy inputs and output cotangents.  The
backward graphs must carry the same structural hash, and the gradients
agree within that test's band, rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autodiff as ref_ad  # noqa: E402
from repro.core import frontend as ref_F  # noqa: E402
from repro_torch.core import autodiff as ad  # noqa: E402
from repro_torch.core import frontend as F  # noqa: E402
from repro_torch.core.ops import differentiable_ops, has_vjp  # noqa: E402

BAND = dict(rtol=1e-4, atol=1e-5)


def _pos(rng, shape):
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


def _std(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _uniform(lo, hi):
    return lambda rng, shape: rng.uniform(lo, hi, shape).astype(np.float32)


CASES = {
    "identity": dict(ins=[(4, 5)], outs=[(4, 5)]),
    "dup": dict(ins=[(4, 5)], outs=[(4, 5), (4, 5)]),
    "relu": dict(ins=[(4, 5)], outs=[(4, 5)]),
    "gelu": dict(ins=[(4, 5)], outs=[(4, 5)]),
    "add": dict(ins=[(4, 5), (4, 5)], outs=[(4, 5)]),
    "vadd": dict(ins=[(4, 5), (4, 5)], outs=[(4, 5)],
                 attrs={"alpha": 1.5, "beta": -0.5}),
    "scale": dict(ins=[(4, 5)], outs=[(4, 5)], attrs={"s": 1.7}),
    "affine": dict(ins=[(4, 5)], outs=[(4, 5)], attrs={"a": -1.0, "b": 0.3}),
    "divc": dict(ins=[(4, 5)], outs=[(4, 5)], attrs={"c": 3.0}),
    "rdivc": dict(ins=[(4, 5)], outs=[(4, 5)], attrs={"c": 2.0}, env=_pos),
    "div": dict(ins=[(4, 5), (4, 5)], outs=[(4, 5)], env=_pos),
    "mul": dict(ins=[(4, 5), (4, 5)], outs=[(4, 5)]),
    "matmul": dict(ins=[(4, 3), (3, 5)], outs=[(4, 5)], op="matmul"),
    "mv": dict(ins=[(4, 3), (3,)], outs=[(4,)], op="matmul",
               loop_shape=(4, 3)),
    "transpose": dict(ins=[(4, 5)], outs=[(5, 4)], op="copy"),
    "reshape": dict(ins=[(4, 5)], outs=[(2, 10)],
                    attrs={"shape": (2, 10)}, op="copy"),
    "concat": dict(ins=[(2, 5), (3, 5)], outs=[(5, 5)], attrs={"axis": 0}),
    "split": dict(ins=[(5, 4)], outs=[(2, 4), (3, 4)],
                  attrs={"axis": 0, "sizes": (2, 3)}),
    "slice": dict(ins=[(5, 6)], outs=[(2, 3)],
                  attrs={"starts": (1, 2), "sizes": (2, 3)}, op="copy"),
    "softmax": dict(ins=[(4, 5)], outs=[(4, 5)], attrs={"axis": -1}),
    "pad2d": dict(ins=[(1, 2, 6, 6)], outs=[(1, 2, 8, 8)],
                  attrs={"pad": 1}, op="copy"),
    "fill_interior": dict(ins=[(1, 2, 6, 6)], outs=[(1, 2, 8, 8)],
                          attrs={"pad": 1}, op="copy"),
    "conv2d": dict(ins=[(1, 2, 6, 6), (3, 2, 3, 3)], outs=[(1, 3, 4, 4)],
                   attrs={"stride": 1, "groups": 1}, op="conv"),
    "maxpool2d": dict(ins=[(1, 2, 6, 6)], outs=[(1, 2, 3, 3)],
                      attrs={"k": 2}, op="pool"),
    "mean": dict(ins=[(4, 5)], outs=[(4,)], attrs={"axes": (1,)}, op="pool",
                 loop_shape=(4, 5)),
    "mean_all": dict(ins=[(4, 5)], outs=[(1, 1)], op="pool"),
    "rglru_scan": dict(ins=[(2, 5, 3), (2, 5, 3)], outs=[(2, 5, 3)],
                       op="scan", env=_uniform(-0.8, 0.8)),
    "ssd_scan": dict(ins=[(4, 2, 3, 2), (4, 2, 1, 1)], outs=[(4, 2, 3, 2)],
                     op="scan", env=_uniform(0.2, 0.9)),
    # No operands, so no cotangents (the rule returns {}): checked through
    # a graph in which they feed a differentiable op.
    "zeros": dict(special="zeros"),
    "const": dict(special="const"),
}


def _case_graph(pkg_F, pkg_ad, kind, case, const_value):
    """The one-op forward graph of ``kind`` in one package (inputs
    x0..xn, the op's outputs marked as graph outputs)."""
    gb = pkg_F.GB(f"{kind}_case")
    b = pkg_ad._BwdBuilder(gb)
    if case.get("special") == "zeros":
        x = gb.input("x0", (4, 5))
        gb.mark_output(gb.add(x, b.zeros((4, 5))))
        return gb.g, [x]
    if case.get("special") == "const":
        x = gb.input("x0", (4, 5))
        c = b.emit("const", (), ((4, 5),),
                   {"value": const_value, "dtype": "float32"}, op="copy")[0]
        gb.mark_output(gb.mul(x, c))
        return gb.g, [x]
    ins = [gb.input(f"x{i}", tuple(s)) for i, s in enumerate(case["ins"])]
    outs = b.emit(kind, tuple(ins), case["outs"], case.get("attrs"),
                  op=case.get("op", "ewise"),
                  loop_shape=case.get("loop_shape"))
    for o in outs:
        gb.mark_output(o)
    gb.g.validate()
    return gb.g, ins


def _grads(pkg_ad, src, ins, env, seeds_by_out, wrap, unwrap):
    """Run ``src``'s backward graph (residual intermediates come from the
    forward run, inputs from ``env``) and return each input's gradient."""
    bb = pkg_ad.build_backward(src, wrt=list(ins))
    fwd = src.copy()
    for r in bb.residuals:
        if fwd.buffers[r].kind == "intermediate":
            fwd.buffers[r].kind = "output"
    fenv = {k: wrap(v) for k, v in env.items()}
    fouts = fwd.execute(fenv)
    benv = {s: wrap(seeds_by_out[o]) for o, s in bb.seeds.items()}
    for r in bb.residuals:
        benv[r] = fouts[r] if r in fouts else fenv[r]
    bouts = bb.graph.execute(benv)
    return bb, {w: unwrap(bouts[bb.grads[w]]) for w in ins}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_vjp_matches_reference(kind):
    case = CASES[kind]
    rng = np.random.default_rng(sorted(CASES).index(kind))
    const_value = tuple(map(tuple, _std(rng, (4, 5)).tolist()))
    src, ins = _case_graph(F, ad, kind, case, const_value)
    ref_src, ref_ins = _case_graph(ref_F, ref_ad, kind, case, const_value)
    assert ins == ref_ins
    assert src.structural_hash() == ref_src.structural_hash()
    env_fn = case.get("env", _std)
    env = {n: env_fn(rng, tuple(src.buffers[n].shape)) for n in ins}
    seeds = {b.name: _std(rng, tuple(b.shape)) for b in src.outputs()}

    bb, got = _grads(ad, src, ins, env, seeds, torch.from_numpy,
                     lambda t: t.numpy())
    ref_bb, want = _grads(ref_ad, ref_src, ins, env, seeds, lambda a: a,
                          np.asarray)
    assert bb.graph.structural_hash() == ref_bb.graph.structural_hash()
    assert bb.residuals == ref_bb.residuals
    for w in ins:
        assert got[w].shape == want[w].shape and got[w].dtype == want[w].dtype
        np.testing.assert_allclose(got[w], want[w], err_msg=f"{kind}: {w}",
                                   **BAND)


def test_vjp_case_coverage():
    """Every differentiable kind has a case here, and the table is the
    reference's."""
    assert set(CASES) == set(differentiable_ops())
    assert all(has_vjp(k) for k in CASES)
