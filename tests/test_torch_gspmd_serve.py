"""The port's sharded serve and prefill steps (``jit_serve_step``,
``jit_prefill_step``) against the JAX reference's, on the CPU.

The port runs on a 4 x 2 ``("data", "model")`` mesh of eight CPU
positions; the reference runs its own steps on a 1 x 1
``jax.sharding.Mesh`` of the one CPU device under ``use_mesh``.  For
gpt2-medium, mamba2-780m, recurrentgemma-9b and mixtral-8x22b at
``smoke()``, from the reference's parameters (``params_from_numpy``):

* four decode steps of 8 slots against a cache of 16: the tokens equal,
  the logits within 1e-5 of their scale (``tests/test_torch_lm.py``'s
  band), every gathered cache leaf within 1e-5 of its own scale and
  ``pos`` exactly; the tokens come back placed over ``data``, the logits
  whole; every cache shard has its spec's local shape and is written in
  place (the same storage before and after: the cache is donated);
* the prefill of a (8, 32) batch: logits within 1e-5 of their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed.sharding import use_mesh as ref_use_mesh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import generator as ref_gen  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import PlacedArray  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_paths  # noqa: E402
from repro_torch.serving import generator as gen  # noqa: E402

ARCHS = ("gpt2-medium", "mamba2-780m", "recurrentgemma-9b", "mixtral-8x22b")
SCALE_BAND = 1e-5
SLOTS, CACHE, STEPS = 8, 16, 4


def _ref_mesh():
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _ref_paths(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_paths(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree, np.float32) if np.asarray(tree).dtype.kind
            in "fV" else np.asarray(tree)}


_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
        rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
        _PAIRS[arch] = (rcfg, cfg, rp, M.params_from_numpy(
            jax.device_get(rp), device="cpu"))
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_steps_match_reference(arch):
    rcfg, cfg, rp, tp = _pair(arch)
    rmesh = _ref_mesh()
    mesh = make_debug_mesh((4, 2), ("data", "model"), device="cpu")
    rcache = ref_tf.init_cache(rcfg, SLOTS, CACHE)
    rstep = ref_gen.jit_serve_step(rcfg, rmesh, rp, rcache)
    cache = tf.init_cache(cfg, SLOTS, CACHE, device="cpu")
    step = gen.jit_serve_step(cfg, mesh, tp, cache)
    rtok = jnp.asarray(np.arange(SLOTS, dtype=np.int32) * 7 % 50)
    tok = np.asarray(rtok)
    ptrs = None
    for _ in range(STEPS):
        with ref_use_mesh(rmesh):
            rtok, rlog, rcache = rstep(rp, rtok, rcache)
        tok, log, cache = step(tp, tok, cache)
        assert isinstance(tok, PlacedArray) and tok.sharding.spec == (
            ("data",),)
        assert [tuple(s.shape) for s in tok.shards] == [(2,)] * 8
        assert isinstance(log, torch.Tensor) and tuple(log.shape) == tuple(
            rlog.shape)
        assert np.array_equal(np.asarray(tok), np.asarray(rtok))
        assert _rel(log.numpy(), np.asarray(rlog)) <= SCALE_BAND
        leaves = tree_leaves(cache)
        assert all(isinstance(a, PlacedArray) for a in leaves)
        now = [s.data_ptr() for a in leaves for s in a.shards]
        assert ptrs is None or now == ptrs          # written in place
        ptrs = now
    for a in tree_leaves(cache):
        want = a.sharding.shard_shape(a.shape)
        assert all(tuple(s.shape) == want for s in a.shards)
    got = {k: v.gather().float().numpy() if v.dtype.is_floating_point
           else v.gather().numpy() for k, v in tree_paths(cache, "").items()}
    want = _ref_paths(jax.device_get(rcache))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("pos"):
            assert int(got[k]) == int(v) == STEPS
        else:
            assert _rel(got[k], v) <= SCALE_BAND, k


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_reference(arch):
    rcfg, cfg, rp, tp = _pair(arch)
    batch = RM.make_batch(rcfg, batch=8, seq=32, kind="prefill")
    with ref_use_mesh(_ref_mesh()):
        want = np.asarray(ref_gen.jit_prefill_step(
            rcfg, _ref_mesh(), rp, batch)(rp, batch))
    tb = {k: np.asarray(v) for k, v in batch.items()}
    mesh = make_debug_mesh((4, 2), ("data", "model"), device="cpu")
    got = gen.jit_prefill_step(cfg, mesh, tp, tb)(tp, tb)
    assert isinstance(got, torch.Tensor)
    assert _rel(got.numpy(), want) <= SCALE_BAND


def test_serve_module_exports_the_sharded_steps():
    import importlib
    import warnings

    import repro_torch.serving as serving
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        serve = importlib.import_module("repro_torch.serving.serve")
    for name in ("jit_serve_step", "jit_prefill_step"):
        assert getattr(serve, name) is getattr(gen, name)
        assert getattr(serving, name) is getattr(gen, name)
        assert name in serve.__all__ and name in serving.__all__
