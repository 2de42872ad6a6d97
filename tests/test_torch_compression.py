"""The port's int8 gradient compression (``repro_torch.distributed.
compression``) against the JAX reference's, on the CPU, bit for bit:
``quantize`` / ``dequantize`` (round half to even, the clip, the 1e-12
floor of an all-zero tensor), ``compress_tree`` with and without error
feedback over three rounds, ``wire_bytes`` of float32 and bfloat16
trees, and ``compressed_allreduce`` under the port's ``shard_map``
against the reference's under ``jax.vmap``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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
    """Named for when ``compressed_allreduce`` was missing: it runs under
    the port's ``shard_map`` now, bit for bit the reference's under
    ``jax.vmap`` (four positions, error feedback carried in), and needs
    the named axes (``tests/test_torch_shard_map.py`` holds it at eight
    positions and in a train step)."""
    from repro_torch.distributed.sharding import P, shard_map
    from repro_torch.launch.mesh import make_debug_mesh
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((4, 9)) * 1e-2).astype(np.float32)
    e = (rng.standard_normal((4, 9)) * 1e-4).astype(np.float32)

    def ours(x, ef):
        red, st = comp.compressed_allreduce({"g": x[0]}, {"ef": {"g": ef[0]}},
                                            ("data",))
        return red["g"][None], st["ef"]["g"][None]

    def theirs(x, ef):
        red, st = ref.compressed_allreduce({"g": x}, {"ef": {"g": ef}},
                                           ("data",))
        return red["g"], st["ef"]["g"]

    mesh = make_debug_mesh((4,), ("data",), device="cpu")
    red, new_ef = shard_map(ours, mesh=mesh, in_specs=P("data"),
                            out_specs=(P("data"), P("data")))(
        torch.from_numpy(g), torch.from_numpy(e))
    want = jax.vmap(theirs, axis_name="data")(jnp.asarray(g), jnp.asarray(e))
    assert np.array_equal(red.numpy(), np.asarray(want[0]))
    assert np.array_equal(new_ef.numpy(), np.asarray(want[1]))
    with pytest.raises(NameError, match="unbound axis"):
        comp.compressed_allreduce({"g": torch.from_numpy(g[0])}, {},
                                  ("data",))
