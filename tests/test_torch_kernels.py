"""The port's kernel modules against the JAX kernels and their oracles.

On the CPU a kernel wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each against
its plain version).  Here each plain version meets the JAX Pallas kernel
in interpret mode and both packages' ``ref.py`` oracles on the same seeded
inputs, at the tolerances of ``tests/test_kernels.py``: 2e-5 in float32,
2e-2 in bfloat16.
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from repro_torch.kernels.flashattn.flashattn import (key_splits,  # noqa: E402
                                                     smem_bytes, tiling_ok)
from repro_torch.kernels.streamfuse import (LIBRARY as CHAIN_LIB,  # noqa: E402
                                            CONV_LIBRARY as CONV_LIB,
                                            GRAD_LIBRARY as GRAD_LIB,
                                            fused_matmul_chain,
                                            fused_matmul_grad,
                                            matmul_chain_plain,
                                            matmul_chain_ref,
                                            matmul_grad_plain,
                                            matmul_grad_ref)
from repro_torch.kernels.streamfuse.chain import (EW_CODES,  # noqa: E402
                                                  GRAD_CODES, GradTail,
                                                  apply_ew_plain,
                                                  apply_grad_ew_plain,
                                                  chunk_columns, ew_codes,
                                                  grad_ew_codes,
                                                  grad_launches,
                                                  grad_one_pass, k_splits)
from repro_torch.kernels.streamfuse.chain import \
    smem_bytes as smem_bytes_chain  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


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
    assert 2 * smem_bytes(1024) <= 228 * 1024      # two blocks fit an SM
    assert not tiling_ok(1025) and not tiling_ok(8192)


@pytest.mark.parametrize("S,BH", [(128, 1), (1024, 1), (256, 8), (77, 3),
                                  (4096, 32)])
def test_flash_key_splits_cover_every_tile(S, BH):
    splits, per = key_splits(S, S, BH)
    tiles = -(-S // 64)
    assert 1 <= splits <= tiles and (splits - 1) * per < tiles <= splits * per
    blocks = -(-S // 16) * BH * splits
    assert blocks >= min(264, -(-S // 16) * BH * tiles) // 2


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
@pytest.mark.parametrize("M,K,N1,N2", [(32, 64, 128, 48), (16, 32, 256, 64)])
def test_chain_plain_matches_jax_kernel(M, K, N1, N2, tail, bf16):
    ew = TAILS[tail]
    a, w1, w2 = (_rand(s, i, 0.3) for i, s in
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
    bn1 = chunk_columns(M, N1)
    chunks = -(-N1 // bn1)
    assert bn1 % 128 == 0 and bn1 > 0
    assert common.smem_ok(smem_bytes_chain(bn1))
    assert chunks * bn1 >= N1 > (chunks - 1) * bn1
    if -(-M // 64) * -(-N1 // 128) >= 132:    # enough work for every SM
        assert -(-M // 64) * chunks >= 132


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
    (128, 4096, 1024, 6), (1024, 4096, 1024, 3), (128, 128, 1024, 16),
    (1024, 1024, 1024, 3), (37, 130, 50, 1), (8, 8, 4096, 64), (4, 4, 3, 1)])
def test_grad_splits_cover_k_and_fill_the_card(M, N, K, want):
    """The route's shapes split K: too few output tiles for the card's
    396 block slots (S=128), or a last wave left short (S=1024)."""
    splits, per = k_splits(M, N, K)
    assert splits == want
    assert per % 8 == 0 and (splits - 1) * per < K <= splits * per
    assert splits == 1 or per >= 64


def test_grad_launch_count_per_call():
    """One launch when the tail is elementwise and K is not split; the row
    pass joins for a softmax_grad or split partial sums."""
    gelu = [("gelu_grad", {}, 0)]
    soft = [("softmax_grad", {}, 0), ("scale", {"s": 0.125}, None)]
    assert grad_launches(37, 130, 50, gelu) == 1
    assert grad_launches(37, 130, 50, soft) == 2
    assert grad_launches(128, 4096, 1024, gelu) == 2     # split K
    assert grad_launches(1024, 4096, 1024, gelu) == 2
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
    libs = (FLASH_LIB, CHAIN_LIB, GRAD_LIB, CONV_LIB)
    for lib in libs:
        path = lib.path
        assert path.parent == common.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(lib.source.stem + "-")
        assert path == lib.path                    # stable
    assert len({lib.path for lib in libs}) == 4
    assert "sm_90a" in " ".join(common.NVCC_FLAGS)


@pytest.mark.parametrize("source,replaces", [
    ("flashattn.cu", "repro/kernels/flashattn/flashattn.py: flash_attention"),
    ("chain.cu", "repro/kernels/streamfuse/chain.py: fused_matmul_chain"),
    ("chain_grad.cu", "repro/kernels/streamfuse/chain.py: fused_matmul_grad"),
    ("pad_conv_relu.cu",
     "repro/kernels/streamfuse/streamfuse.py: fused_pad_conv_relu"),
])
def test_kernel_sources_name_what_they_replace(source, replaces):
    text = (common.CSRC / source).read_text()
    head = text.split("#include")[0]
    assert "Replaces: " + replaces in " ".join(head.replace("//", "").split())
    assert "What bounds it" in head and "What the design does" in head


def test_build_directory_is_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert common.BUILD_DIR.relative_to(REPO).parts[0] == "build"
