"""The scans' backwards in the PyTorch port against the JAX reference, on
the CPU.

``rglru_scan`` and ``ssd_chunk_scan`` are ``torch.autograd.Function``s in
the port (``kernels/{rglru,ssd}``): one forward launch, and one backward
launch — rglru's forward scan once more on reversed operands
(``rglru_scan_backward``), ssd's reverse kernel
(``ssd_chunk_scan_backward``).  On the CPU both launches are the kernels'
plain versions.  Held here:

* the wrappers' autograd gradients against ``jax.vjp`` of the reference's
  sequential ``_rglru_reference`` / ``_ssd_reference`` and the kernels'
  oracles ``rglru_ref`` / ``ssd_chunk_scan_ref``, at a ragged last chunk
  (S = 37 over 16-step chunks, 300 over 64), one step, and bfloat16
  operands: float32 within ``F32_BAND`` of each gradient's largest value
  (measured ≤ 1.8e-7), bfloat16 within ``BF16_BAND`` (measured ≤ 7.4e-3:
  λ is rounded to bfloat16 before ``da = λ·h``);
* the wrappers are differentiable and each backward is one more scan
  (the fault that lost the recurrent branch's gradients on the card);
* ``ssd_chunk_scan_backward_plain`` itself against ``jax.vjp`` at ragged
  P·N, one chunk and bfloat16;
* ``core/ops.py``'s ``rglru_scan_grad`` / ``ssd_scan_grad`` against the
  reference registry's on the same inputs (``test_torch_ops.py``'s band);
* the models: every gradient of ``rglru_block_train`` (``lam``, ``w_a``,
  ``w_i`` among them) and of ``ssd_chunked`` against ``jax.grad``, within
  ``MODEL_BAND`` of each gradient's scale (measured ≤ 4.5e-7).

The CUDA launches run on the card (``chip_smoke.py``'s train phase).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import ops as ref_ops  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as ref_rglru_oracle  # noqa: E402
from repro.kernels.ssd.ref import ssd_chunk_scan_ref  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import rglru as rglru_pkg  # noqa: E402
from repro_torch.kernels import ssd as ssd_pkg  # noqa: E402
from repro_torch.kernels.rglru.rglru import chunk_length  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

# the kernel modules (the packages export a function named like the first)
rglru_mod = importlib.import_module("repro_torch.kernels.rglru.rglru")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd.ssd")

F32_BAND = 1e-6          # of each gradient's largest value
BF16_BAND = 2e-2
MODEL_BAND = 1e-5
OPS_BAND = dict(rtol=1e-6, atol=2e-6)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if scale == 0:
        assert not np.abs(got).any()
        return 0.0
    return float(np.abs(got - want).max() / scale)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _vjp(fn, x, y, g):
    """``jax.vjp`` of ``fn`` at ``(x, y)`` for the cotangent ``g``, jitted
    (op by op the reference's scans take seconds)."""
    return jax.jit(lambda x, y, g: jax.vjp(fn, x, y)[1](g))(x, y, g)


def _jnp32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# The wrappers' backwards against jax.vjp
# --------------------------------------------------------------------------

RGLRU_CASES = {"ragged_37": ((2, 37, 6), "f32"),
               "ragged_300": ((2, 300, 16), "f32"),
               "one_step": ((3, 1, 4), "f32"),
               "bf16_300": ((2, 300, 16), "bf16")}
RGLRU_REFS = {"sequential": ref_ops._rglru_reference,
              "oracle": ref_rglru_oracle}


def _rglru_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("ref", sorted(RGLRU_REFS))
@pytest.mark.parametrize("case", sorted(RGLRU_CASES))
def test_rglru_backward_matches_jax_vjp(case, ref):
    shape, dt = RGLRU_CASES[case]
    jd, td = DTYPES[dt]
    a, b, g = _rglru_inputs(shape)
    da_w, db_w = _vjp(RGLRU_REFS[ref], jnp.asarray(a).astype(jd),
                      jnp.asarray(b).astype(jd), jnp.asarray(g).astype(jd))
    ta = torch.from_numpy(a).to(td).requires_grad_()
    tb = torch.from_numpy(b).to(td).requires_grad_()
    h = rglru_pkg.rglru(ta, tb, chunk=chunk_length(*shape))
    assert h.dtype == td
    h.backward(torch.from_numpy(g).to(td))
    assert ta.grad.dtype == tb.grad.dtype == td
    band = F32_BAND if dt == "f32" else BF16_BAND
    assert _rel(_np(ta.grad), _jnp32(da_w)) <= band
    assert _rel(_np(tb.grad), _jnp32(db_w)) <= band


SSD_CASES = {"odd_chunks": ((7, 4, 8, 16), "f32"),
             "small": ((6, 3, 4, 5), "f32"),
             "one_chunk": ((1, 2, 3, 4), "f32"),
             "bf16": ((7, 4, 8, 16), "bf16")}


def _ssd_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    nc, BH = shape[:2]
    return ((0.1 * rng.standard_normal(shape)).astype(np.float32),
            rng.uniform(0.5, 0.99, (nc, BH, 1, 1)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("ref", ["sequential", "oracle"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_matches_jax_vjp(case, ref):
    shape, dt = SSD_CASES[case]
    jd, td = DTYPES[dt]
    st, dec, g = _ssd_inputs(shape)
    fn = ref_ops._ssd_reference if ref == "sequential" else ssd_chunk_scan_ref
    jst, jdec = jnp.asarray(st).astype(jd), jnp.asarray(dec).astype(jd)
    if ref == "sequential" and dt == "bf16":
        # the registry's reference carries its state in the operands' type
        jst, jdec = jst.astype(jnp.float32), jdec.astype(jnp.float32)
    ds_w, dd_w = _vjp(fn, jst, jdec, jnp.asarray(g).astype(jst.dtype))
    ts = torch.from_numpy(st).to(td).requires_grad_()
    tdec = torch.from_numpy(dec).to(td).requires_grad_()
    h = ssd_pkg.ssd_states(ts, tdec)
    h.backward(torch.from_numpy(g).to(td))
    assert ts.grad.dtype == tdec.grad.dtype == td
    band = F32_BAND if dt == "f32" else BF16_BAND
    assert _rel(_np(ts.grad), _jnp32(ds_w)) <= band
    assert _rel(_np(tdec.grad), _jnp32(dd_w)) <= band


# The reverse kernel's plain version, called directly: ragged P·N (not a
# multiple of the kernel's four elements a thread, and past one block's
# 1024), one chunk, and bfloat16 (μ rounded to it before μ·h).
SSD_PLAIN_CASES = {"ragged": ((5, 3, 7, 9), "f32"),
                   "wide": ((4, 2, 33, 37), "f32"),
                   "one_chunk": ((1, 2, 3, 4), "f32"),
                   "bf16": ((6, 3, 8, 16), "bf16"),
                   "bf16_ragged": ((5, 3, 7, 9), "bf16")}


@pytest.mark.parametrize("ref", ["sequential", "oracle"])
@pytest.mark.parametrize("case", sorted(SSD_PLAIN_CASES))
def test_ssd_backward_plain_matches_jax_vjp(case, ref):
    """``ssd_chunk_scan_backward_plain`` — the reverse loop the backward
    kernel runs — against ``jax.vjp`` of the reference's sequential
    ``_ssd_reference`` and of the oracle ``ssd_chunk_scan_ref``, within
    the bands of :func:`test_ssd_backward_matches_jax_vjp`."""
    shape, dt = SSD_PLAIN_CASES[case]
    jd, td = DTYPES[dt]
    st, dec, g = _ssd_inputs(shape, seed=11)
    fn = ref_ops._ssd_reference if ref == "sequential" else ssd_chunk_scan_ref
    jst, jdec = jnp.asarray(st).astype(jd), jnp.asarray(dec).astype(jd)
    if ref == "sequential" and dt == "bf16":
        # the registry's reference carries its state in the operands' type
        jst, jdec = jst.astype(jnp.float32), jdec.astype(jnp.float32)
    ds_w, dd_w = _vjp(fn, jst, jdec, jnp.asarray(g).astype(jst.dtype))
    ts, tdec, tg = (torch.from_numpy(x).to(td) for x in (st, dec, g))
    h = ssd_mod.ssd_chunk_scan_plain(ts, tdec)
    ds, dd = ssd_mod.ssd_chunk_scan_backward_plain(tg, tdec, h)
    assert ds.dtype == dd.dtype == td
    assert tuple(dd.shape) == tuple(dec.shape)
    band = F32_BAND if dt == "f32" else BF16_BAND
    assert _rel(_np(ds), _jnp32(ds_w)) <= band
    assert _rel(_np(dd), _jnp32(dd_w)) <= band
    # the wrapper on the CPU is its plain version, bit for bit
    for got, want in zip(ssd_mod.ssd_chunk_scan_backward(tg, tdec, h),
                         (ds, dd)):
        assert torch.equal(got, want)


def test_wrappers_are_differentiable_with_one_scan_each_way(monkeypatch):
    """Each wrapper's output has a backward, and that backward is exactly
    one more scan: rglru's one more launch of its forward kernel, ssd's one
    call of its reverse kernel's wrapper (on the card: one launch)."""
    calls = []
    for mod, name in ((rglru_mod, "rglru_scan"), (ssd_mod, "ssd_chunk_scan"),
                      (ssd_mod, "ssd_chunk_scan_backward")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    a, b, g = (torch.from_numpy(x) for x in _rglru_inputs((2, 40, 8)))
    a.requires_grad_(), b.requires_grad_()
    h = rglru_pkg.rglru(a, b, chunk=16)
    assert type(h.grad_fn).__name__ == "RglruScanBackward"
    assert calls == ["rglru_scan"]
    h.backward(g)
    assert calls == ["rglru_scan"] * 2
    assert bool(a.grad.abs().min() >= 0) and bool(a.grad.abs().max() > 0)
    assert bool(b.grad.abs().max() > 0)
    st, dec, g = (torch.from_numpy(x) for x in _ssd_inputs((5, 3, 4, 4)))
    st.requires_grad_(), dec.requires_grad_()
    h = ssd_pkg.ssd_states(st, dec)
    assert type(h.grad_fn).__name__ == "SsdChunkScanBackward"
    assert calls[2:] == ["ssd_chunk_scan"]
    h.backward(g)
    assert calls[2:] == ["ssd_chunk_scan", "ssd_chunk_scan_backward"]
    assert bool(st.grad.abs().max() > 0) and bool(dec.grad.abs().max() > 0)


def test_backward_helpers_are_the_reverse_recurrence():
    """``rglru_scan_backward``'s λ is the reverse recurrence written out
    step by step; ``ssd_chunk_scan_backward``'s μ_{c+1} likewise."""
    a, b, g = (torch.from_numpy(x).double().float()
               for x in _rglru_inputs((2, 23, 5), seed=3))
    h = rglru_mod.rglru_scan_plain(a, b, chunk=8)
    da, db = rglru_mod.rglru_scan_backward(g, a, h, chunk=8)
    lam = g[:, -1]
    lams = [lam]
    for t in range(a.shape[1] - 2, -1, -1):
        lam = g[:, t] + a[:, t + 1] * lam
        lams.append(lam)
    want = torch.stack(lams[::-1], dim=1)
    torch.testing.assert_close(db, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(da[:, 1:], want[:, 1:] * h[:, :-1],
                               rtol=1e-6, atol=1e-6)
    assert not da[:, 0].any()
    st, dec, g = (torch.from_numpy(x) for x in _ssd_inputs((6, 2, 3, 4), 4))
    hs = ssd_mod.ssd_chunk_scan_plain(st, dec)
    dst, ddec = ssd_mod.ssd_chunk_scan_backward(g, dec, hs)
    mu = torch.zeros_like(st[0])
    for c in range(st.shape[0] - 1, -1, -1):
        torch.testing.assert_close(dst[c], mu, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            ddec[c], (mu * hs[c]).sum(dim=(-2, -1), keepdim=True),
            rtol=1e-6, atol=1e-6)
        mu = g[c] + dec[c] * mu


# --------------------------------------------------------------------------
# The compiled path's gradient ops
# --------------------------------------------------------------------------

OPS_CASES = {
    "rglru_ragged": ("rglru_scan_grad", ("g", "a", "b"), ("da", "db"),
                     lambda: (lambda a, b, g: [g, a, 0.1 * b])(
                         *_rglru_inputs((2, 53, 7), seed=5))),
    "rglru_long": ("rglru_scan_grad", ("g", "a", "b"), ("da", "db"),
                   lambda: (lambda a, b, g: [g, a, 0.1 * b])(
                       *_rglru_inputs((1, 300, 8), seed=6))),
    "ssd": ("ssd_scan_grad", ("g", "s", "d"), ("ds", "dd"),
            lambda: (lambda st, dec, g: [g, st, dec])(
                *_ssd_inputs((9, 3, 4, 6), seed=7))),
}


@pytest.mark.parametrize("case", sorted(OPS_CASES))
def test_scan_grad_ops_match_reference_registry(case):
    kind, ins, outs, make = OPS_CASES[case]
    arrays = make()
    env = dict(zip(ins, arrays))
    got = ops.materialize(ops.OpSpec(kind, ins, outs))(
        {k: torch.from_numpy(v) for k, v in env.items()})
    want = ref_ops.materialize(ref_ops.OpSpec(kind, ins, outs))(env)
    for k in outs:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **OPS_BAND)


# --------------------------------------------------------------------------
# The models' gradients against jax.grad
# --------------------------------------------------------------------------


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def test_rglru_block_gradients_match_jax_grad():
    """Every gradient of ``rglru_block_train`` (the recurrent branch's
    ``in_x``, ``conv``, ``w_a``, ``w_i``, ``lam`` among them) at a ragged
    S = 45 (16-step chunks) against ``jax.grad``."""
    rcfg = ref_get_config("recurrentgemma-9b").smoke()
    cfg = get_config("recurrentgemma-9b").smoke()
    rp = ref_rglru.init_rglru_block(jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 45, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 45, rcfg.d_model)).astype(np.float32)

    def ref_loss(p):
        return jnp.sum(ref_rglru.rglru_block_train(p, jnp.asarray(x), rcfg)
                       * jnp.asarray(w))

    want = _flat(jax.device_get(jax.jit(jax.grad(ref_loss))(rp)))
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = (rg.rglru_block_train(tp, torch.from_numpy(x), cfg)
            * torch.from_numpy(w)).sum()
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))
    assert {"/lam", "/w_a/w", "/w_i/w", "/in_x/w", "/conv"} <= set(names)
    for n in names:
        assert bool(grads[n].abs().max() > 0), n
        assert _rel(_np(grads[n]), want[n]) <= MODEL_BAND, n


def test_ssd_chunked_gradients_match_jax_grad():
    """Every operand's gradient of ``ssd_chunked`` (the inter-chunk scan
    through ``ssd_chunk_scan``) against ``jax.grad``, the final state's
    cotangent included."""
    rng = np.random.default_rng(12)
    b, s, h, p, n, chunk = 2, 96, 4, 8, 16, 16
    args = [rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.05, 0.5, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32)]
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    wh = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def ref_loss(*xs):
        y, hl = ref_ssm.ssd_chunked(*xs, chunk)
        return jnp.sum(y * wy) + jnp.sum(hl * wh)

    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, hl = ssm.ssd_chunked(*ts, chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (hl * torch.from_numpy(wh)).sum()
    grads = torch.autograd.grad(loss, ts)
    for i, (g, wg) in enumerate(zip(grads, want)):
        assert _rel(_np(g), np.asarray(wg)) <= MODEL_BAND, i
