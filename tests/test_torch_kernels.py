"""The port's kernel modules against the JAX kernels and their oracles.

On the CPU a kernel wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each against
its plain version).  Here each plain version meets the JAX Pallas kernel
in interpret mode and both packages' ``ref.py`` oracles on the same seeded
inputs, at the tolerances of ``tests/test_kernels.py``: 2e-5 in float32,
2e-2 in bfloat16.
"""

import importlib
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as ref_ops  # noqa: E402
from repro.kernels.flashattn.flashattn import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flashattn.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.streamfuse.chain import \
    fused_matmul_chain as jax_chain  # noqa: E402
from repro.kernels.streamfuse.chain import \
    fused_matmul_grad as jax_grad  # noqa: E402
from repro.kernels.streamfuse.ref import \
    matmul_grad_ref as jax_grad_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flashattn import (LIBRARY as FLASH_LIB,  # noqa: E402
                                           attention_ref, flash_attention,
                                           flash_attention_plain, flash_attn)
from repro_torch.kernels.flashattn.flashattn import (  # noqa: E402
    cluster_size, flash_launches, head_columns, key_splits, smem_bytes,
    tile_strides, tiling_ok)
from repro_torch.kernels.streamfuse import (LIBRARY as CHAIN_LIB,  # noqa: E402
                                            CONV_LIBRARY as CONV_LIB,
                                            GRAD_LIBRARY as GRAD_LIB,
                                            fused_matmul_chain,
                                            fused_matmul_grad,
                                            matmul_chain_plain,
                                            matmul_chain_ref,
                                            matmul_grad_plain,
                                            matmul_grad_ref)
from repro_torch.kernels.streamfuse.chain import (  # noqa: E402
    EW_CODES, GRAD_CODES, ChainTail, GradTail, apply_ew_plain,
    apply_grad_ew_plain,
    chain_form, chain_launches, cluster_chunks, cluster_shape,
    cluster_smem_bytes, ew_codes, grad_ew_codes, grad_launches,
    grad_one_pass, k_splits, row_columns, row_splits, rows_smem_bytes)
from repro.kernels.matmul.matmul import matmul as jax_matmul  # noqa: E402
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref  # noqa: E402
from repro.kernels.rglru.rglru import rglru_scan as jax_rglru  # noqa: E402
from repro.kernels.ssd.ref import \
    ssd_chunk_scan_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd.ssd import ssd_chunk_scan as jax_ssd  # noqa: E402
from repro.kernels.streamfuse.chain import \
    fused_softmax_matmul as jax_softmax_mm  # noqa: E402
from repro.kernels.streamfuse.ref import \
    softmax_matmul_ref as jax_softmax_mm_ref  # noqa: E402
from repro_torch.kernels import matmul as mm_pkg  # noqa: E402
from repro_torch.kernels import rglru as rglru_pkg  # noqa: E402
from repro_torch.kernels import ssd as ssd_pkg  # noqa: E402
from repro_torch.kernels.streamfuse import (SOFTMAX_LIBRARY,  # noqa: E402
                                            fused_softmax_matmul,
                                            softmax_matmul_plain,
                                            softmax_matmul_ref)
from repro_torch.kernels.streamfuse.chain import (  # noqa: E402
    softmax_mm_columns, softmax_mm_launches, softmax_mm_smem_bytes,
    softmax_mm_splits)

REPO = Path(__file__).resolve().parents[1]
# The reference's associative-scan oracle, compiled once a shape (op by
# op it takes seconds a call).
jax_rglru_ref = jax.jit(rglru_ref)


def _tol(bf16: bool):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(x, bf16):
    t = torch.from_numpy(x)
    return t.bfloat16() if bf16 else t


def _j(x, bf16):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_SHAPES = [(1, 2, 2, 64, 32), (2, 4, 2, 64, 16), (1, 4, 1, 128, 32)]
MASKS = [(True, 0), (False, 0), (True, 32)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,Hq,Hkv,S,hd", FLASH_SHAPES)
def test_flash_plain_matches_jax_kernel(B, Hq, Hkv, S, hd, causal, window,
                                        bf16):
    q, k, v = (_rand(s, i) for i, s in enumerate(
        [(B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)]))
    got = flash_attention(_t(q, bf16), _t(k, bf16), _t(v, bf16),
                          causal=causal, window=window)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    want = jax_flash(_j(q, bf16), _j(k, bf16), _j(v, bf16), causal=causal,
                     window=window, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    oracle = attention_ref(_t(q, bf16), _t(k, bf16), _t(v, bf16),
                           causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(bf16))


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_ref_matches_jax_ref(causal, window):
    q, k, v = (_rand((2, 4, 48, 16), i) for i in range(3))
    k, v = k[:, :2], v[:, :2]
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window)
    want = jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S", [50, 77])
def test_flash_plain_takes_a_ragged_edge(S):
    """The TPU kernel asserts divisibility; the port masks the edge."""
    q, k, v = (torch.from_numpy(_rand((1, 2, S, 24), i)) for i in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = jax_attention_ref(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                v.numpy())), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_scale_and_strided_k_as_the_route_uses_them():
    """The routed chain passes its own scale and kᵀ as a transposed view."""
    q, kt, v = _rand((32, 64), 0), _rand((64, 32), 1), _rand((32, 64), 2)
    c = 0.125
    tq, tkt, tv = map(torch.from_numpy, (q, kt, v))
    got = flash_attention(tq[None, None], tkt.transpose(-1, -2)[None, None],
                          tv[None, None], causal=False, scale=c)[0, 0]
    want = torch.softmax(c * (tq @ tkt), dim=-1) @ tv
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    # The TPU route's equivalent: pre-scale q by c·√hd, default scale.
    jq = jnp.asarray(q * (c * math.sqrt(64)))[None, None]
    jk = jnp.asarray(kt.T)[None, None]
    want_jax = jax_flash(jq, jk, jnp.asarray(v)[None, None], causal=False,
                         block_q=32, block_k=32, interpret=True)[0, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=2e-5,
                               atol=2e-5)


def test_flash_attn_dispatch():
    q, k, v = (torch.from_numpy(_rand((1, 2, 32, 16), i)) for i in range(3))
    torch.testing.assert_close(flash_attn(q, k, v, use_kernel=False),
                               attention_ref(q, k, v))
    torch.testing.assert_close(flash_attn(q, k, v),
                               flash_attention_plain(q, k, v))


def test_flash_rejects_bad_operands():
    q = torch.zeros(1, 3, 8, 4)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 8, 4))
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])


def test_flash_tiling_exists_at_gpt2_medium_width():
    assert tiling_ok(1024) and smem_bytes(1024) <= common.SMEM_PER_BLOCK
    assert (cluster_size(1024), head_columns(1024)) == (4, 256)
    assert not tiling_ok(1025) and not tiling_ok(8192)


@pytest.mark.parametrize("hd", [16, 32, 40, 64, 100, 128, 200, 256, 257, 512,
                                700, 1024])
def test_flash_shared_memory_fits_every_head_dim(hd):
    """Each block holds head_columns(hd) ≤ 256 columns; a cluster of at
    most 4 covers hd; float32 and bfloat16 tiles fit a block's shared
    memory."""
    c, n = cluster_size(hd), head_columns(hd)
    assert n in (32, 64, 128, 256) and 1 <= c <= 4
    assert c * n >= hd and (c == 1 or n == 256)
    assert c == 1 or (c - 1) * 256 < hd        # no idle rank
    for itemsize in (4, 2):
        assert common.smem_ok(smem_bytes(hd, itemsize))
        # Every tile row, a K tile stored by d too, starts 16-byte aligned.
        assert all(ld * itemsize % 16 == 0
                   for ld in tile_strides(hd, itemsize))


@pytest.mark.parametrize("S,BH,hd", [(128, 1, 1024), (1024, 1, 1024),
                                     (256, 8, 64), (77, 3, 40),
                                     (4096, 32, 128), (2048, 16, 256)])
def test_flash_key_splits_cover_every_tile(S, BH, hd):
    splits, per = key_splits(S, S, BH, hd)
    tiles = -(-S // 64)
    assert 1 <= splits <= tiles and (splits - 1) * per < tiles <= splits * per
    blocks = -(-S // 64) * cluster_size(hd) * BH
    assert blocks * splits >= min(132, blocks * tiles) // 2
    if blocks >= 132:                           # the grid fills the card
        assert splits == 1
    assert flash_launches(S, S, BH, hd) == (1 if splits == 1 else 2)


def test_flash_launches_at_the_paths_shapes():
    """mha_batched (16 heads, S = 2048, hd = 256) fills the card in one
    split, one launch; gpt2_block's single head at hd = 1024 splits its
    keys and combines them, two."""
    assert flash_launches(2048, 2048, 16, 256) == 1
    assert flash_launches(128, 128, 1, 1024) == 2
    assert flash_launches(1024, 1024, 1, 1024) == 2


# --------------------------------------------------------------------------
# fused matmul chain
# --------------------------------------------------------------------------

TAILS = {
    "bare": (),
    "gelu": (("gelu", {}),),
    "relu_scale": (("relu", {}), ("scale", {"s": 0.5})),
    "affine_divc": (("affine", {"a": -1.0, "b": 0.25}), ("divc", {"c": 3.0})),
    "affine_rdivc": (("affine", {"a": 1.0, "b": 4.0}), ("rdivc", {"c": 2.0}),
                     ("identity", {})),
}


def _ref_tail(ew):
    """The tail as the reference builds it: registry impls as callables."""
    fns = []
    for kind, attrs in ew:
        spec = ref_ops.OpSpec(kind, ("x",), ("y",), dict(attrs))
        fns.append(lambda h, _s=spec: ref_ops.op_impl(_s.kind)(_s, {"x": h})["y"])
    return fns


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("M,K,N1,N2", [(32, 64, 128, 48), (16, 32, 256, 64),
                                      (1, 1000, 128, 48), (2, 1024, 256, 64)])
def test_chain_plain_matches_jax_kernel(M, K, N1, N2, tail, bf16):
    ew = TAILS[tail]
    # Operands shrink with the depth past 64, so that h stays O(1) and
    # the rdivc tail stays away from its pole at every K.
    scale = 0.3 * min(1.0, 8.0 / math.sqrt(K))
    a, w1, w2 = (_rand(s, i, scale) for i, s in
                 enumerate([(M, K), (K, N1), (N1, N2)]))
    got = fused_matmul_chain(_t(a, bf16), _t(w1, bf16), _t(w2, bf16), ew=ew)
    assert got.shape == (M, N2)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    want = jax_chain(_j(a, bf16), _j(w1, bf16), _j(w2, bf16),
                     ew=_ref_tail(ew), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    if not bf16:
        oracle = matmul_chain_ref(*map(torch.from_numpy, (a, w1, w2)),
                                  ew=[lambda h, _e=e: apply_ew_plain(h, [_e])
                                      for e in ew])
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_ew_codes_cover_every_ew_kind():
    from repro.kernels.streamfuse.ops import EW_KINDS as REF_EW_KINDS
    from repro_torch.kernels.streamfuse.ops import EW_KINDS
    assert set(EW_CODES) == set(EW_KINDS) == set(REF_EW_KINDS)
    ops, a, b = ew_codes([("affine", {"a": 2.0, "b": -1.0}),
                          ("rdivc", {"c": 3.0}), ("gelu", {})])
    assert (ops, a, b) == ([4, 6, 2], [2.0, 3.0, 0.0], [-1.0, 0.0, 0.0])
    assert ew_codes([("affine", {"b": 5.0})]) == ([4], [1.0], [5.0])
    with pytest.raises(ValueError, match="softmax"):
        ew_codes([("softmax", {})])
    with pytest.raises(ValueError, match="at most"):
        ew_codes([("relu", {})] * 9)


@pytest.mark.parametrize("M,N1", [(16, 256), (128, 4096), (1024, 4096),
                                  (100, 1000), (8192, 4096)])
def test_chain_chunking_fills_the_card_and_fits(M, N1):
    """Either form's tiling covers the shape and fits a block: the small
    form's splits cover K, the cluster form's chunks cover N1 and its
    ranks' columns cover N2, c ≤ 8 blocks of 64 columns of h a chunk."""
    K, N2 = 1024, 1024
    if chain_form(M, K, N1) == "rows":
        splits, kper = row_splits(M, K, N1)
        assert kper % 32 == 0 and (splits - 1) * kper < K <= splits * kper
        assert max(rows_smem_bytes(M, K, N1)) <= common.SMEM_PER_BLOCK
        return
    c, ncr = cluster_shape(N1, N2)
    chunks = cluster_chunks(N1, N2)
    bn1 = 64 * c
    assert 1 <= c <= 8 and bn1 % c == 0 and ncr % 64 == 0
    assert chunks * bn1 >= N1 > (chunks - 1) * bn1
    assert c * ncr >= N2 > (c - 1) * ncr - 64
    assert common.smem_ok(cluster_smem_bytes())
    if -(-M // 64) * -(-N1 // 64) >= 132:     # enough work for every SM
        assert -(-M // 64) * chunks * c >= 132


@pytest.mark.parametrize("M,K,N1,N2,form", [
    (1, 25088, 512, 512, "rows"),             # VGG-16's head
    (16, 1000, 200, 72, "rows"),
    (1, 1024, 65536, 64, "cluster"),          # h's row past shared memory
    (17, 1024, 512, 512, "cluster"),
    (128, 1024, 4096, 1024, "cluster"),       # gpt2_block's FFN
    (1024, 1024, 4096, 1024, "cluster"),
])
def test_chain_form_follows_the_shape(M, K, N1, N2, form):
    assert chain_form(M, K, N1) == form
    assert chain_launches(M, K, N1, N2) == 2


@pytest.mark.parametrize("M,K,N1,itemsize", [(1, 25088, 512, 4),
                                             (1, 25088, 512, 2),
                                             (3, 1000, 200, 4), (16, 96, 72, 4),
                                             (16, 4096, 1024, 2)])
def test_chain_row_splits_cover_k_and_fill_the_card(M, K, N1, itemsize):
    splits, kper = row_splits(M, K, N1, itemsize)
    assert kper % 32 == 0 and 64 <= kper and M * kper <= 16384
    assert (splits - 1) * kper < K <= splits * kper
    tiles = -(-N1 // row_columns(itemsize))
    assert tiles * splits >= min(132, tiles * -(-K // 64))
    if (K, N1) == (25088, 512):               # the head: >= 132 blocks,
        assert tiles * splits >= 132          # partials under 1 MB
        assert 4 * splits * N1 < 1 << 20
    assert max(rows_smem_bytes(M, K, N1, itemsize)) <= common.SMEM_PER_BLOCK


def test_chain_cluster_partials_shrink_at_gpt2_widths():
    """The float32 partials the second launch sums: PR 11's kernel wrote
    one a 128 columns of h at S=128 (32 chunks) and a 512-column chunk at
    S=1024 (8); a cluster chunk is 512 columns at both."""
    assert cluster_shape(4096, 1024) == (8, 128)
    assert cluster_chunks(4096, 1024) * 4 <= 32


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, nearest, ties away), as the
    kernels round the high part."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_read(x):
    """x as the tensor cores read a TF32 operand: its top 19 bits."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("M,K,N", [(4, 1024, 256), (1, 25088, 64)])
def test_three_tf32_products_keep_float32_accuracy(M, K, N):
    """The premise of the kernels' 3×TF32 split: at the chain's depths
    (gpt2_block's K = 1024, VGG-16's head K = 25088) hi·hi + hi·lo + lo·hi,
    lo = x − hi read as TF32, in float32 stays within the card's float32
    band (1e-4·(1 + scale)), and one TF32 product does not."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32_read(a - a_hi), _tf32_read(w - w_hi)
    three = (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi
    one = a_hi @ w_hi
    band = 1e-4 * (1 + np.abs(exact).max())
    assert np.abs(three - exact).max() <= band / 10
    assert np.abs(one - exact).max() > band


def _gelu_grad(h, x):
    """h · gelu'(x), the tanh gelu's derivative as the op registry writes
    it."""
    c = np.sqrt(2.0 / np.pi)
    t = np.tanh(c * (x + 0.044715 * x ** 3))
    return h * (0.5 * (1 + t) + 0.5 * x * (1 - t * t) * c
                * (1 + 3 * 0.044715 * x * x))


def _mm(x, y):
    """x @ y in x's type without BLAS (whose thread pool makes small
    products slow on a busy host)."""
    return np.einsum("mk,kn->mn", x, y)


def _three_tf32(a, w):
    """a @ w as the kernels' three TF32 products, summed in float32."""
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32_read(a - a_hi), _tf32_read(w - w_hi)
    return (_mm(a_lo, w_hi) + _mm(a_hi, w_lo)) + _mm(a_hi, w_hi)


@pytest.mark.parametrize("case", ["softmax_pv", "mmgrad_gelu_grad"])
def test_three_tf32_products_at_the_redesigned_kernels(case):
    """The 3×TF32 premise at the shapes of this port's two newest tensor-
    core kernels: rows of a softmax over K = 2048 keys against V (2048,
    256) (fused_softmax_matmul at a RecurrentGemma-9B head), and the
    mmgrad FFN product at K = 1024 followed by gelu_grad.  Three products
    stay within a tenth of the card's route band (1e-4·(1 + scale)) and
    gain at least ten times over one TF32 product."""
    rng = np.random.default_rng(1)
    if case == "softmax_pv":
        s = rng.standard_normal((4, 2048))
        p = np.exp(s - s.max(-1, keepdims=True))
        a = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        w = rng.standard_normal((2048, 256)).astype(np.float32)
        tail = (lambda h: h)
    else:
        a = rng.standard_normal((4, 1024)).astype(np.float32)
        w = (rng.standard_normal((1024, 1024)) / 32).astype(np.float32)
        x = rng.standard_normal((4, 1024))
        tail = (lambda h: _gelu_grad(h, x))
    exact = tail(_mm(a.astype(np.float64), w.astype(np.float64)))
    three = tail(_three_tf32(a, w).astype(np.float64))
    one = tail(_mm(_tf32(a), _tf32(w)).astype(np.float64))
    band = 1e-4 * (1 + np.abs(exact).max())
    err3, err1 = np.abs(three - exact).max(), np.abs(one - exact).max()
    assert err3 <= band / 10
    assert err1 >= 10 * err3


def _round_toward_zero(x64):
    """float64 values to float32 rounded toward zero: the tensor cores'
    float32 accumulation as this emulation models it."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _accumulate(a, w, rnd, block=0):
    """The three TF32 products summed in the kernels' k order (8-deep
    steps, the small terms first, each step's 8-term dot exact and rounded
    once into the accumulator by ``rnd``, one mma).  block > 0: each
    block-deep stretch into a fresh accumulator, added into a float32 one
    with round-to-nearest (the promotion)."""
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32_read(a - a_hi), _tf32_read(w - w_hi)
    run = np.zeros((a.shape[0], w.shape[1]), np.float32)
    cur = run.copy()
    for k in range(0, a.shape[1], 8):
        for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
            cur = rnd(cur.astype(np.float64) + _mm(
                x[:, k:k + 8].astype(np.float64),
                y[k:k + 8].astype(np.float64)))
        if block and (k + 8) % block == 0:
            run, cur = run + cur, np.zeros_like(cur)
    return run if block else cur


@pytest.mark.parametrize("case,block", [("mmgrad", 8), ("softmax_pv", 64),
                                        ("conv", 32)])
def test_promotion_bounds_a_truncating_accumulator(case, block):
    """Part of the 3×TF32 error is the tensor cores' own float32
    accumulation, which rounds each mma's sum toward zero in this model
    (it reproduces the card's reading: ~10× the round-to-nearest error at
    K = 1024, chip_smoke.py's precision phase).  Promoting each block-deep
    stretch into a float32 accumulator by round-to-nearest adds — every
    8-deep step at mmgrad's FFN product (the trial in PERF.md §6, which
    mmgrad does not keep), every 64-key tile in softmaxmm and every 32-deep
    stage of the conv's 64-channel tile (here over a 4608-deep window),
    which do — takes the error back to the round-to-nearest level."""
    rng = np.random.default_rng(2)
    if case == "mmgrad":
        a = rng.standard_normal((4, 1024)).astype(np.float32)
        w = (rng.standard_normal((1024, 256)) / 32).astype(np.float32)
    elif case == "conv":        # weights over √fan-in, unit inputs
        a = (rng.standard_normal((4, 4608)) / 68).astype(np.float32)
        w = rng.standard_normal((4608, 64)).astype(np.float32)
    else:                       # unnormalized probabilities, as accumulated
        s = 2 * rng.standard_normal((4, 2048))
        a = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
        w = rng.standard_normal((2048, 256)).astype(np.float32)
    exact = _mm(a.astype(np.float64), w.astype(np.float64))

    def err(x):
        return np.abs(x - exact).max()

    nearest = err(_accumulate(a, w, lambda x: x.astype(np.float32)))
    truncated = err(_accumulate(a, w, _round_toward_zero))
    promoted = err(_accumulate(a, w, _round_toward_zero, block))
    assert truncated >= 5 * nearest
    assert promoted <= 2 * nearest


@pytest.mark.parametrize("case,gain", [("chain", 8), ("flash_scores", 5)])
def test_stage_promotion_bounds_the_chains_accumulation(case, gain):
    """chain.cu's tile takes gpt2_block's FFN first product (K = 1024,
    w1 over √K) in 32-deep stages, each into a fresh tensor-core
    accumulator added into the running one with round-to-nearest; so does
    flash's QKᵀ over each cluster block's 256 head-dim columns (q and k
    unit normals: scores of ~±50 before the scale).  In this model that
    cuts the truncating accumulator's error at least eightfold for the
    chain (the card's precision phase read 4.48e-5 there unpromoted, 5.6
    times cuBLAS float32) and fivefold for the scores, against
    accumulating every product in one, and brings both within twice the
    round-to-nearest level."""
    rng = np.random.default_rng(3)
    if case == "chain":
        a = rng.standard_normal((4, 1024)).astype(np.float32)
        w = (rng.standard_normal((1024, 256)) / 32).astype(np.float32)
    else:                       # one warp's 16 rows against a 64-key tile
        a = rng.standard_normal((16, 256)).astype(np.float32)
        w = rng.standard_normal((256, 64)).astype(np.float32)
    exact = _mm(a.astype(np.float64), w.astype(np.float64))

    def err(x):
        return np.abs(x - exact).max()

    nearest = err(_accumulate(a, w, lambda x: x.astype(np.float32)))
    whole = err(_accumulate(a, w, _round_toward_zero))
    staged = err(_accumulate(a, w, _round_toward_zero, 32))
    assert gain * staged <= whole
    assert staged <= 2 * nearest


def test_split_sums_bound_the_wide_conv_tiles_accumulation():
    """The conv's 128-channel tile lets the tensor cores accumulate each
    split of the window whole, and its plan keeps a split at most
    CONV_WIDE_DEPTH deep; the splits are summed in float32 with
    round-to-nearest.  At VGG-16's 4608-deep window that cuts the
    truncating accumulator's error eightfold or more against one split
    (the card reads the same on the kernel, chip_smoke.py's precision
    phase)."""
    from repro_torch.kernels.streamfuse.streamfuse import CONV_WIDE_DEPTH
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((4, 4608)) / 68).astype(np.float32)
    w = rng.standard_normal((4608, 64)).astype(np.float32)
    exact = _mm(a.astype(np.float64), w.astype(np.float64))

    def err(x):
        return np.abs(x - exact).max()

    whole = err(_accumulate(a, w, _round_toward_zero))
    split = err(_accumulate(a, w, _round_toward_zero, CONV_WIDE_DEPTH))
    assert 8 * split <= whole


def test_chain_rejects_bad_operands():
    with pytest.raises(ValueError, match="chain"):
        fused_matmul_chain(torch.zeros(4, 3), torch.zeros(4, 5),
                           torch.zeros(5, 2))
    with pytest.raises(TypeError):
        fused_matmul_chain(torch.zeros(4, 3).double(), torch.zeros(3, 5),
                           torch.zeros(5, 2))


# --------------------------------------------------------------------------
# fused matmul + gradient epilogue (backward chains)
# --------------------------------------------------------------------------

# Tails as (kind, attrs, extra index); "x" extras are unit normals, "y"
# extras rows of a softmax.
GRAD_TAILS = {
    "relu_grad": ((("relu_grad", {}, 0),), "x"),
    "gelu_grad": ((("gelu_grad", {}, 0),), "x"),
    "softmax_grad_scale": ((("softmax_grad", {"axis": -1}, 0),
                            ("scale", {"s": 0.125}, None)), "y"),
    "mixed": ((("divc", {"c": 3.0}, None), ("softmax_grad", {"axis": 1}, 0),
               ("affine", {"a": -1.0, "b": 0.25}, None),
               ("relu_grad", {}, 1), ("gelu", {}, None),
               ("identity", {}, None)), "yx"),
}


def _grad_operands(M, K, N, extras, w_t, bf16, seed=0):
    """Seeded numpy a (M, K), w (K, N) — built as (N, K) and handed over
    transposed when ``w_t`` — and the extras, with torch and jax twins."""
    a = _rand((M, K), seed, 0.3)
    w = _rand((N, K), seed + 1, 0.3).T if w_t else _rand((K, N), seed + 1,
                                                           0.3)
    x = _rand((M, N), seed + 2)
    y = np.exp(x - x.max(1, keepdims=True))
    y = (y / y.sum(1, keepdims=True)).astype(np.float32)
    ex = [{"x": x, "y": y}[k] for k in extras]
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).t() if w_t else \
        torch.from_numpy(w)
    tw = tw.bfloat16() if bf16 else tw
    return (a, w, ex), (_t(a, bf16), tw, [_t(e, bf16) for e in ex])


def _ref_grad_tail(ew):
    """The tail as the reference builds it: registry impls as one
    ``ew(h, *extras)`` callable."""
    def fn(h, *extras):
        for kind, attrs, idx in ew:
            ins = ("h",) if idx is None else ("h", "e")
            spec = ref_ops.OpSpec(kind, ins, ("o",), dict(attrs))
            env = {"h": h} if idx is None else {"h": h, "e": extras[idx]}
            h = ref_ops.op_impl(kind)(spec, env)["o"]
        return h
    return fn


@pytest.mark.parametrize("tail", sorted(GRAD_TAILS))
@pytest.mark.parametrize("M,K,N,w_t,bf16", [
    (32, 64, 48, False, False), (32, 64, 48, True, False),
    (37, 50, 130, False, False), (37, 50, 130, True, False),
    (32, 64, 48, True, True)])
def test_grad_plain_matches_jax_kernel(M, K, N, w_t, bf16, tail):
    ew, kinds = GRAD_TAILS[tail]
    (a, w, ex), (ta, tw, tex) = _grad_operands(M, K, N, kinds, w_t, bf16)
    assert tw.is_contiguous() != w_t
    got = fused_matmul_grad(ta, tw, *tex, ew=ew)
    assert got.shape == (M, N)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    want = jax_grad(_j(a, bf16), _j(w, bf16), *(_j(e, bf16) for e in ex),
                    ew=_ref_grad_tail(ew), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    if not bf16:
        oracle = matmul_grad_ref(ta, tw, tex, lambda h, *e: apply_grad_ew_plain(
            h, ew, e))
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **_tol(False))
        jax_oracle = jax_grad_ref(jnp.asarray(a), jnp.asarray(w),
                                  [jnp.asarray(e) for e in ex],
                                  _ref_grad_tail(ew))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_oracle),
                                   **_tol(False))


def test_grad_plain_reads_transposed_and_expanded_operands():
    """The route hands w over as a transposed view and may hand an extra
    over as an ``expand`` view (``bcast``): both go in as they are."""
    a = torch.from_numpy(_rand((24, 40), 0)).t()          # (40, 24) view
    w = torch.from_numpy(_rand((16, 24), 1)).t()          # (24, 16) view
    e = torch.from_numpy(_rand((1, 16), 2)).expand(40, 16)
    assert e.stride(0) == 0 and a.stride(0) == 1 and w.stride(0) == 1
    ew = (("relu_grad", {}, 0), ("scale", {"s": 2.0}, None))
    got = fused_matmul_grad(a, w, e, ew=ew)
    want = 2.0 * (a.contiguous() @ w.contiguous()) * (e.contiguous() > 0)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_grad_codes_cover_every_tail_kind():
    from repro.kernels.streamfuse.ops import EW_KINDS as REF_EW_KINDS
    from repro.kernels.streamfuse.ops import GRAD_EW_KINDS as REF_GRAD_KINDS
    from repro_torch.kernels.streamfuse.ops import GRAD_EW_KINDS
    assert set(GRAD_CODES) == set(REF_EW_KINDS) | set(REF_GRAD_KINDS)
    assert GRAD_EW_KINDS == REF_GRAD_KINDS
    assert {k: GRAD_CODES[k] for k in EW_CODES} == EW_CODES
    assert grad_ew_codes([("gelu_grad", {}, 1), ("affine", {"b": 2.0}, None),
                          ("softmax_grad", {"axis": -1}, 0)], 2) == (
        [8, 4, 9], [0.0, 1.0, 0.0], [0.0, 2.0, 0.0], [1, -1, 0])
    with pytest.raises(ValueError, match="residual"):
        grad_ew_codes([("relu_grad", {}, None)], 1)
    with pytest.raises(ValueError, match="residual"):
        grad_ew_codes([("relu_grad", {}, 1)], 1)
    with pytest.raises(ValueError, match="no residual"):
        grad_ew_codes([("relu", {}, 0)], 1)
    with pytest.raises(ValueError, match="softmax'"):
        grad_ew_codes([("softmax", {}, None)], 0)
    with pytest.raises(ValueError, match="at most"):
        grad_ew_codes([("relu", {}, None)] * 9, 0)


@pytest.mark.parametrize("M,N,K,want", [
    (128, 4096, 1024, 4), (1024, 4096, 1024, 1), (128, 128, 1024, 16),
    (1024, 1024, 1024, 4), (37, 130, 50, 1), (8, 8, 4096, 64), (4, 4, 3, 1)])
def test_grad_splits_cover_k_and_fill_the_card(M, N, K, want):
    """The route's shapes split K where the 128 x 128 tiles are too few
    for the card's 132 SMs (the FFN chain at S=128 has 32, the attention
    chain at S=1024 64), and the FFN chain at S=1024 (256 tiles, two a
    SM) does not split."""
    splits, per = k_splits(M, N, K)
    assert splits == want
    assert per % 32 == 0 and (splits - 1) * per < K <= splits * per
    assert splits == 1 or per >= 64


def test_grad_launch_count_per_call():
    """One launch when the tail is elementwise and K is not split; the row
    pass joins for a softmax_grad or split partial sums."""
    gelu = [("gelu_grad", {}, 0)]
    soft = [("softmax_grad", {}, 0), ("scale", {"s": 0.125}, None)]
    assert grad_launches(37, 130, 50, gelu) == 1
    assert grad_launches(37, 130, 50, soft) == 2
    assert grad_launches(128, 4096, 1024, gelu) == 2     # split K
    assert grad_launches(1024, 4096, 1024, gelu) == 1
    assert grad_launches(128, 128, 1024, soft) == 2
    assert grad_one_pass(37, 130, 50, gelu)
    assert not grad_one_pass(128, 4096, 1024, gelu)


def test_prepared_tail_gives_the_same_result_and_keeps_its_arrays():
    """The mmgrad factory hands the wrapper a GradTail built once a
    route: the same answer as the stages themselves, the op codes as the
    kernel takes them, and one set of stride arrays per stride pattern."""
    ew = (("softmax_grad", {}, 0), ("scale", {"s": 0.125}, None),
          ("relu_grad", {}, 1))
    tail = GradTail(ew, 2)
    assert (tail.n_ops, tail.first_sg) == (3, 0)
    n, ops, _, _, ex, n_extras = tail.codes
    assert (n, list(ops), list(ex), n_extras) == (
        3, [GRAD_CODES[k][0] for k, _, _ in ew], [0, -1, 1], 2)
    a = torch.from_numpy(_rand((12, 20), 0))
    w = torch.from_numpy(_rand((16, 20), 1)).t()
    y = torch.softmax(torch.from_numpy(_rand((12, 16), 2)), -1)
    x = torch.from_numpy(_rand((12, 16), 3))
    torch.testing.assert_close(fused_matmul_grad(a, w, y, x, ew=tail),
                               matmul_grad_plain(a, w, y, x, ew=ew),
                               rtol=0, atol=0)
    first, again = tail.args((y, x)), tail.args((y.clone(), x.clone()))
    assert first[-2] is again[-2] and first[-1] is again[-1]
    assert list(first[-2]) == [16, 16] and list(first[-1]) == [1, 1]
    with pytest.raises(ValueError, match="built for 2 extras"):
        fused_matmul_grad(a, w, y, ew=tail)


def test_prepared_chain_tail_gives_the_same_result_and_holds_its_codes():
    """The mmchain factory hands the wrapper a ChainTail built once a
    route: the op codes and attributes as the kernel takes them, and the
    same answer as the stages themselves."""
    ew = (("affine", {"a": -1.0, "b": 4.0}), ("rdivc", {"c": 2.0}),
          ("gelu", {}))
    tail = ChainTail(ew)
    assert tail.ew == ew and tail.struct.n == 3
    ops, ea, eb = ew_codes(ew)
    assert list(tail.struct.op)[:3] == ops == [4, 6, 2]
    assert list(tail.struct.a)[:3] == ea and list(tail.struct.b)[:3] == eb
    a, w1, w2 = (torch.from_numpy(_rand(s, i))
                 for i, s in enumerate([(5, 12), (12, 9), (9, 7)]))
    torch.testing.assert_close(fused_matmul_chain(a, w1, w2, ew=tail),
                               matmul_chain_plain(a, w1, w2, ew=ew),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="at most"):
        ChainTail((("relu", {}),) * 9)


def test_grad_rejects_bad_operands():
    z = torch.zeros
    with pytest.raises(ValueError, match="chain"):
        fused_matmul_grad(z(4, 3), z(4, 5), ew=())
    with pytest.raises(ValueError, match="extras"):
        fused_matmul_grad(z(4, 3), z(3, 5), z(5, 4), ew=(("relu_grad", {}, 0),))
    with pytest.raises(TypeError):
        fused_matmul_grad(z(4, 3), z(3, 5), z(4, 5).double(),
                          ew=(("relu_grad", {}, 0),))
    with pytest.raises(ValueError, match="residual"):
        matmul_grad_plain(z(4, 3), z(3, 5), ew=(("gelu_grad", {}, 0),))


# --------------------------------------------------------------------------
# dispatch and the build
# --------------------------------------------------------------------------
# softmax -> matmul (the attention tail)
# --------------------------------------------------------------------------

# (M, K, N): blocks the TPU kernel tiles (128 rows, 128 keys) and a single
# row block; the band is flash's.
SOFTMAX_MM_SHAPES = [(128, 256, 64), (256, 128, 32), (64, 64, 96)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,K,N", SOFTMAX_MM_SHAPES)
def test_softmax_mm_plain_matches_jax_kernel(M, K, N, bf16):
    s, v = _rand((M, K), 0, 2.0), _rand((K, N), 1)
    got = fused_softmax_matmul(_t(s, bf16), _t(v, bf16))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    torch.testing.assert_close(got, softmax_matmul_plain(_t(s, bf16),
                                                         _t(v, bf16)),
                               rtol=0, atol=0)
    want = jax_softmax_mm(_j(s, bf16), _j(v, bf16), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    if not bf16:
        np.testing.assert_allclose(_np(got), _np(jax_softmax_mm_ref(
            _j(s, False), _j(v, False))), **_tol(False))
        np.testing.assert_allclose(_np(softmax_matmul_ref(_t(s, False),
                                                          _t(v, False))),
                                   _np(want), **_tol(False))


def test_softmax_mm_plain_takes_ragged_and_strided_operands():
    """No dimension divides a block, and s arrives as a transposed view."""
    s, v = _rand((77, 50), 2), _rand((77, 30), 3)
    ts = torch.from_numpy(s).t()               # (50, 77), strided
    got = fused_softmax_matmul(ts, torch.from_numpy(v))
    want = jax_softmax_mm_ref(jnp.asarray(s.T), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(False))


@pytest.mark.parametrize("M,K,N,splits", [(1024, 1024, 64, 16),
                                          (2048, 2048, 256, 4),
                                          (64, 64, 600, 1), (16, 50, 8, 1)])
def test_softmax_mm_splits_cover_every_tile(M, K, N, splits):
    """The route shapes split the keys to fill one wave of the card (16
    and 64 blocks of 64 rows), every key tile in exactly one split, and
    wide N is tiled."""
    got, per = softmax_mm_splits(M, K, N)
    tiles = -(-K // 64)
    assert got == splits and per * (got - 1) < tiles <= per * got
    assert softmax_mm_launches(M, K, N) == (1 if got == 1 else 2)
    assert softmax_mm_columns(N) == (64 if N <= 64 else 128)
    assert common.smem_ok(softmax_mm_smem_bytes(N))


def test_softmax_mm_rejects_bad_operands():
    s = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="s \\(M, K\\)"):
        fused_softmax_matmul(s, torch.zeros(8, 4))
    with pytest.raises(TypeError):
        fused_softmax_matmul(s, torch.zeros(16, 4).double())


# --------------------------------------------------------------------------
# the RG-LRU recurrence
# --------------------------------------------------------------------------

# The reference sweep (tests/test_kernels.py): (B, S, D, chunk), gates in
# [0.5, 0.999), inputs 0.1 · N(0, 1); band 1e-4.
RGLRU_SWEEP = [(2, 256, 64, 128), (1, 128, 128, 32), (3, 64, 32, 64)]
RGLRU_TOL = dict(rtol=1e-4, atol=1e-4)


def _rglru_operands(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32)
    b = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,D,chunk", RGLRU_SWEEP)
def test_rglru_plain_matches_jax_kernel(B, S, D, chunk):
    a, b = _rglru_operands(B, S, D)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = rglru_pkg.rglru(ta, tb, chunk=chunk)
    torch.testing.assert_close(got, rglru_pkg.rglru_scan_plain(
        ta, tb, chunk=chunk), rtol=0, atol=0)
    want = np.asarray(jax_rglru(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **RGLRU_TOL)
    oracle = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), oracle, **RGLRU_TOL)
    np.testing.assert_allclose(rglru_pkg.rglru_ref(ta, tb).numpy(), oracle,
                               **RGLRU_TOL)
    torch.testing.assert_close(rglru_pkg.rglru(ta, tb, use_kernel=False),
                               rglru_pkg.rglru_ref(ta, tb), rtol=0, atol=0)


@pytest.mark.parametrize("S,chunk", [(100, 16), (100, 7), (100, 128)])
def test_rglru_plain_takes_a_ragged_sequence(S, chunk):
    """S no chunk divides (the TPU kernel asserts S % chunk == 0): held
    against the reference's associative-scan oracle, and the chunk moves
    the result only within the band."""
    a, b = _rglru_operands(2, S, 24, seed=S)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = rglru_pkg.rglru_scan(ta, tb, chunk=chunk)
    oracle = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), oracle, **RGLRU_TOL)
    np.testing.assert_allclose(got.numpy(), rglru_pkg.rglru_scan(
        ta, tb, chunk=S).numpy(), **RGLRU_TOL)


def _rglru_passes(a, b, chunk):
    """h_t = a_t·h_{t−1} + b_t in numpy float32, chunk by chunk: every
    chunk's summary (product of its a's, end state) from a zero state,
    each chunk's carried-in state as the earlier summaries folded in order
    from zero, then the chunk from that state."""
    B, S, D = a.shape
    starts = range(0, S, chunk)
    prod, local = [], []
    for t0 in starts:
        p, h = np.ones((B, D), np.float32), np.zeros((B, D), np.float32)
        for t in range(t0, min(S, t0 + chunk)):
            p, h = p * a[:, t], a[:, t] * h + b[:, t]
        prod.append(p)
        local.append(h)
    out = np.empty_like(a)
    for c, t0 in enumerate(starts):
        h = np.zeros((B, D), np.float32)
        for j in range(c):
            h = prod[j] * h + local[j]
        for t in range(t0, min(S, t0 + chunk)):
            h = a[:, t] * h + b[:, t]
            out[:, t] = h
    return out


@pytest.mark.parametrize("S,chunk", [(128, 16), (100, 32)])
def test_rglru_plain_is_summaries_fold_apply(S, chunk):
    """rglru_scan_plain computes, bit for bit, the arithmetic the one-pass
    kernel repeats: summaries from zero, the in-order fold from zero, the
    apply (S = 100 leaves a last chunk of 4 steps)."""
    a, b = _rglru_operands(2, S, 24, seed=S + chunk)
    got = rglru_pkg.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b),
                                     chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), _rglru_passes(a, b, chunk))


def test_rglru_constants_mirror_the_source():
    """The wrapper's copies of csrc/rglru_scan.cu's constants: channels a
    block, steps held, blocks an SM and the state's header; and the state
    a call needs, a flag for each (chunk, strip, batch) block."""
    mod = importlib.import_module("repro_torch.kernels.rglru.rglru")
    src = (common.CSRC / "rglru_scan.cu").read_text()
    assert f"constexpr int THREADS = {mod.THREADS};" in src
    assert f"constexpr int HELD = {mod.HELD};" in src
    assert f"FLAGS = {mod.STATE_HEADER};" in src
    assert f"__launch_bounds__(THREADS, {mod.BLOCKS_PER_SM})" in src
    assert mod.state_words(2, 2048, 4096, 64) == 96 + 2 * 32 * 32
    assert mod.state_words(2, 100, 130, 32) == 96 + 2 * 2 * 4


def test_rglru_bf16_carries_the_state_in_f32():
    a, b = _rglru_operands(2, 64, 16, seed=5)
    got = rglru_pkg.rglru_scan(torch.from_numpy(a).bfloat16(),
                               torch.from_numpy(b).bfloat16(), chunk=16)
    assert got.dtype == torch.bfloat16
    want = jax_rglru(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                     chunk=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(True))


def test_rglru_rejects_bad_operands():
    x = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="\\(B, S, D\\)"):
        rglru_pkg.rglru_scan(x, torch.zeros(2, 8, 5))
    with pytest.raises(ValueError, match="chunk"):
        rglru_pkg.rglru_scan(x, x, chunk=0)
    with pytest.raises(TypeError):
        rglru_pkg.rglru_scan(x, x.double())


# --------------------------------------------------------------------------
# the SSD chunk-state scan
# --------------------------------------------------------------------------

# The reference sweep: (nc, BH, P, N), states 0.1 · N(0, 1), decays in
# [0.5, 0.99); band 1e-5.
SSD_SWEEP = [(8, 4, 16, 32), (4, 8, 8, 16), (16, 2, 32, 8), (5, 3, 7, 9)]
SSD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nc,BH,P,N", SSD_SWEEP)
def test_ssd_plain_matches_jax_kernel(nc, BH, P, N):
    rng = np.random.default_rng(nc * BH)
    st = (rng.standard_normal((nc, BH, P, N)) * 0.1).astype(np.float32)
    dec = rng.uniform(0.5, 0.99, (nc, BH, 1, 1)).astype(np.float32)
    tst, tdec = torch.from_numpy(st), torch.from_numpy(dec)
    got = ssd_pkg.ssd_states(tst, tdec)
    torch.testing.assert_close(got, ssd_pkg.ssd_chunk_scan_plain(tst, tdec),
                               rtol=0, atol=0)
    want = np.asarray(jax_ssd(jnp.asarray(st), jnp.asarray(dec),
                              interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)
    oracle = np.asarray(jax_ssd_ref(jnp.asarray(st), jnp.asarray(dec)))
    np.testing.assert_allclose(got.numpy(), oracle, **SSD_TOL)
    np.testing.assert_allclose(ssd_pkg.ssd_states(tst, tdec,
                                                  use_kernel=False).numpy(),
                               oracle, **SSD_TOL)
    assert not got[0].any()                  # h_0 = 0, emitted first


def test_ssd_rejects_bad_operands():
    st = torch.zeros(4, 2, 3, 5)
    with pytest.raises(ValueError, match="decay must be"):
        ssd_pkg.ssd_chunk_scan(st, torch.zeros(4, 2, 3, 1))
    with pytest.raises(ValueError, match="4-D"):
        ssd_pkg.ssd_chunk_scan(st[0], torch.zeros(2, 1, 1))
    with pytest.raises(TypeError):
        ssd_pkg.ssd_chunk_scan(st, torch.zeros(4, 2, 1, 1).double())


def test_ssd_backward_rejects_bad_operands():
    g, dec = torch.zeros(4, 2, 3, 5), torch.zeros(4, 2, 1, 1)
    with pytest.raises(ValueError, match="shaped as h"):
        ssd_pkg.ssd_chunk_scan_backward(g[:, :, :2], dec, g)
    with pytest.raises(ValueError, match="decay must be"):
        ssd_pkg.ssd_chunk_scan_backward(g, dec[:3], g)
    with pytest.raises(ValueError, match="4-D"):
        ssd_pkg.ssd_chunk_scan_backward(g[0], dec[0], g[0])
    with pytest.raises(TypeError):
        ssd_pkg.ssd_chunk_scan_backward(g, dec.double(), g.double())
    with pytest.raises(TypeError, match="share"):     # h not decay's type
        ssd_pkg.ssd_chunk_scan_backward(g, dec, g.bfloat16())
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_pkg.ssd_chunk_scan_backward(g, dec, g.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_backward_on_meta_charges_its_kernel(dtype, monkeypatch):
    """On meta tensors the backward wrapper returns meta ``(dstates,
    ddecay)`` and charges one kernel: g, decay and h read once, both
    results written once, four flops an element (μ·dec + g, μ·h and its
    sum); the plain version never runs."""
    from repro_torch.launch import hlo_analysis as ha
    mod = importlib.import_module("repro_torch.kernels.ssd.ssd")

    def refuse(*a, **k):
        raise AssertionError("the plain backward ran on meta tensors")

    monkeypatch.setattr(mod, "ssd_chunk_scan_backward_plain", refuse)
    nc, BH, P, N = 5, 3, 7, 9
    g, h = (torch.empty(nc, BH, P, N, dtype=dtype, device="meta")
            for _ in range(2))
    dec = torch.empty(nc, BH, 1, 1, dtype=dtype, device="meta")
    with ha.CostWalker() as walker:
        ds, dd = mod.ssd_chunk_scan_backward(g, dec, h)
    assert ds.device.type == dd.device.type == "meta"
    assert ds.shape == g.shape and dd.shape == dec.shape
    assert ds.dtype == dd.dtype == dtype
    n, size = g.numel(), g.element_size()
    assert walker.cost.bytes == size * (3 * n + 2 * dec.numel())
    assert walker.cost.flops == 4.0 * n and walker.cost.ops == 1


# --------------------------------------------------------------------------
# the blocked matmul
# --------------------------------------------------------------------------

# Shapes of the reference sweep (tests/test_kernels.py); its bands: 1e-3
# in float32, rtol 5e-2 / atol 5e-1 in bfloat16 (unit normals, K up to
# 384: bfloat16 rounding of the output alone is ~4e-3 relative).
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 128, 384)])
def test_matmul_plain_matches_jax_kernel(M, N, K, bf16):
    a, b = _rand((M, K), 0), _rand((K, N), 1)
    got = mm_pkg.mm(_t(a, bf16), _t(b, bf16))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    torch.testing.assert_close(got, mm_pkg.matmul_plain(_t(a, bf16),
                                                        _t(b, bf16)),
                               rtol=0, atol=0)
    tol = dict(rtol=5e-2, atol=5e-1) if bf16 else dict(rtol=1e-3, atol=1e-3)
    want = jax_matmul(_j(a, bf16), _j(b, bf16), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(jax_matmul_ref(
        _j(a, bf16), _j(b, bf16))), **tol)
    np.testing.assert_allclose(_np(mm_pkg.mm(_t(a, bf16), _t(b, bf16),
                                             use_kernel=False)),
                               _np(want), **tol)


@pytest.mark.parametrize("M,N", [(100, 130), (70, 130), (128, 128), (1, 1),
                                 (1024, 4096)])
def test_matmul_grid_covers_m_and_n(M, N):
    """One block a 128 x 128 tile, the last row and column masked: the
    grid covers M and N with no tile wholly outside; at the route shape
    its 256 tiles are one wave of two blocks a SM."""
    gx, gy = mm_pkg.matmul_grid(M, N)
    assert (gx - 1) * 128 < N <= gx * 128
    assert (gy - 1) * 128 < M <= gy * 128
    if (M, N) == (1024, 4096):
        assert gx * gy == 256 <= 2 * common.NUM_SMS


def test_matmul_takes_a_ragged_edge_and_rejects_bad_operands():
    a, b = _rand((70, 33), 4), _rand((33, 130), 5)
    got = mm_pkg.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="\\(K, N\\)"):
        mm_pkg.matmul(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(TypeError):
        mm_pkg.matmul(torch.zeros(4, 3), torch.zeros(3, 2).double())
    with pytest.raises(ValueError, match="positive"):
        mm_pkg.mm(torch.zeros(4, 3), torch.zeros(3, 2), block_k=0)


# --------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    before = FLASH_LIB.launches, CHAIN_LIB.launches
    q = torch.from_numpy(_rand((1, 1, 16, 8), 0))
    torch.testing.assert_close(flash_attention(q, q, q),
                               flash_attention_plain(q, q, q), rtol=0, atol=0)
    a = torch.from_numpy(_rand((8, 8), 1))
    torch.testing.assert_close(fused_matmul_chain(a, a, a, ew=TAILS["gelu"]),
                               matmul_chain_plain(a, a, a, ew=TAILS["gelu"]),
                               rtol=0, atol=0)
    assert (FLASH_LIB.launches, CHAIN_LIB.launches) == before
    assert FLASH_LIB._lib is None and CHAIN_LIB._lib is None   # nothing built


def test_cpu_tensors_run_the_grad_plain_version_and_launch_nothing():
    before = GRAD_LIB.launches
    a, x = (torch.from_numpy(_rand((8, 8), i)) for i in range(2))
    ew = (("gelu_grad", {}, 0),)
    torch.testing.assert_close(fused_matmul_grad(a, a, x, ew=ew),
                               matmul_grad_plain(a, a, x, ew=ew),
                               rtol=0, atol=0)
    assert GRAD_LIB.launches == before and GRAD_LIB._lib is None


def test_cpu_tensors_run_the_new_plain_versions_and_launch_nothing():
    libs = (SOFTMAX_LIBRARY, rglru_pkg.LIBRARY, ssd_pkg.LIBRARY,
            mm_pkg.LIBRARY)
    before = [lib.launches for lib in libs]
    x = torch.from_numpy(_rand((2, 8, 8), 0))
    fused_softmax_matmul(x[0], x[1])
    rglru_pkg.rglru_scan(x, x, chunk=4)
    ssd_pkg.ssd_chunk_scan(x[:, :, None], x[:, :, :1, None])
    ssd_pkg.ssd_chunk_scan_backward(x[:, :, None], x[:, :, :1, None],
                                    x[:, :, None])
    mm_pkg.matmul(x[0], x[1])
    assert [lib.launches for lib in libs] == before
    assert all(lib._lib is None for lib in libs)


def test_launch_counts_reset_together():
    lib = common.CudaLibrary("chain.cu", {})
    lib.launches, lib.entry_launches["codo_matmul_chain"] = 2, 1
    lib.reset_counts()
    assert lib.launches == 0 and not lib.entry_launches


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="one CUDA device"):
        common.on_card(torch.zeros(2), torch.zeros(2, device="meta"))
    assert common.on_card(torch.zeros(2), torch.zeros(3)) is False


def test_library_paths_hash_the_sources():
    libs = (FLASH_LIB, CHAIN_LIB, GRAD_LIB, CONV_LIB, SOFTMAX_LIBRARY,
            rglru_pkg.LIBRARY, ssd_pkg.LIBRARY, mm_pkg.LIBRARY)
    for lib in libs:
        path = lib.path
        assert path.parent == common.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(lib.source.stem + "-")
        assert path == lib.path                    # stable
    assert len({lib.path for lib in libs}) == 8
    assert {lib.source.name for lib in libs} == {
        p.name for p in common.CSRC.glob("*.cu")}
    assert "sm_90a" in " ".join(common.NVCC_FLAGS)


@pytest.mark.parametrize("source,replaces", [
    ("flashattn.cu", "repro/kernels/flashattn/flashattn.py: flash_attention"),
    ("chain.cu", "repro/kernels/streamfuse/chain.py: fused_matmul_chain"),
    ("chain_grad.cu", "repro/kernels/streamfuse/chain.py: fused_matmul_grad"),
    ("pad_conv_relu.cu",
     "repro/kernels/streamfuse/streamfuse.py: fused_pad_conv_relu"),
    ("softmax_mm.cu",
     "repro/kernels/streamfuse/chain.py: fused_softmax_matmul"),
    ("rglru_scan.cu", "repro/kernels/rglru/rglru.py: rglru_scan"),
    ("ssd_scan.cu", "repro/kernels/ssd/ssd.py: ssd_chunk_scan"),
    ("matmul.cu", "repro/kernels/matmul/matmul.py: matmul"),
])
def test_kernel_sources_name_what_they_replace(source, replaces):
    text = (common.CSRC / source).read_text()
    head = text.split("#include")[0]
    assert "Replaces: " + replaces in " ".join(head.replace("//", "").split())
    assert "What bounds it" in head and "What the design does" in head


def test_every_included_header_exists():
    """Each quoted #include of a kernel source names a header of csrc/
    (the SIMT gemm_tile.cuh is gone; matmul.cu and the conv run
    mma_gemm.cuh)."""
    import re
    for src in [*common.CSRC.glob("*.cu"), *common.CSRC.glob("*.cuh")]:
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (common.CSRC / name).is_file(), (src.name, name)
    uses = {p.name for p in common.CSRC.glob("*.cu")
            if '#include "mma_gemm.cuh"' in p.read_text()}
    assert uses == {"chain_grad.cu", "matmul.cu", "pad_conv_relu.cu"}


def test_build_directory_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert common.BUILD_DIR.relative_to(REPO).parts[0] == "build"
