"""The port's int8 gradient compression (``repro_torch.distributed.
compression``) against the JAX reference's, on the CPU, bit for bit:
``quantize`` / ``dequantize`` (round half to even, the clip, the 1e-12
floor of an all-zero tensor), ``compress_tree`` with and without error
feedback over three rounds, and ``wire_bytes`` of float32 and bfloat16
trees."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as ref  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((16, 8)).astype(np.float32)},
            "b": (1e-3 * rng.standard_normal((33,))).astype(np.float32),
            "z": np.zeros((4,), np.float32)}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_quantize_and_dequantize_bit_for_bit():
    x = np.array([0.5, -1.5, 2.5, 127.0, -127.0, 63.5, 0.0, 1e-9],
                 np.float32)
    for arr in (x, np.zeros(3, np.float32), _grads(0)["a"]["w"]):
        q, s = comp.quantize(torch.from_numpy(arr))
        rq, rs = ref.quantize(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(comp.dequantize(q, s).numpy(),
                                      np.asarray(ref.dequantize(rq, rs)))


def test_compress_tree_with_error_feedback_bit_for_bit():
    ef = ref_ef = None
    for r in range(3):
        g = _grads(r)
        q, s, ef = comp.compress_tree(_t(g), ef)
        rq, rs, ref_ef = ref.compress_tree(g, ref_ef)
        _equal(q, rq)
        _equal(s, rs)
        _equal(ef, ref_ef)


def test_wire_bytes_match_reference():
    g = _grads(1)
    for compressed in (False, True):
        assert comp.wire_bytes(_t(g), compressed) == ref.wire_bytes(
            g, compressed)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16)
          for k, v in (("x", g["b"]), ("y", g["z"]))}
    tbf = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in bf.items()}
    assert comp.wire_bytes(tbf, False) == ref.wire_bytes(bf, False) == 74
    assert len(tree_leaves(tbf)) == 2


def test_compressed_allreduce_waits_for_the_sharded_step():
    assert not hasattr(comp, "compressed_allreduce")
