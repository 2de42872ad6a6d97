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
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flashattn import (LIBRARY as FLASH_LIB,  # noqa: E402
                                           attention_ref, flash_attention,
                                           flash_attention_plain, flash_attn)
from repro_torch.kernels.flashattn.flashattn import (key_splits,  # noqa: E402
                                                     smem_bytes, tiling_ok)
from repro_torch.kernels.streamfuse import (LIBRARY as CHAIN_LIB,  # noqa: E402
                                            fused_matmul_chain,
                                            matmul_chain_plain,
                                            matmul_chain_ref)
from repro_torch.kernels.streamfuse.chain import (EW_CODES,  # noqa: E402
                                                  apply_ew_plain,
                                                  chunk_columns, ew_codes)
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


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="one CUDA device"):
        common.on_card(torch.zeros(2), torch.zeros(2, device="meta"))
    assert common.on_card(torch.zeros(2), torch.zeros(3)) is False


def test_library_paths_hash_the_sources():
    for lib in (FLASH_LIB, CHAIN_LIB):
        path = lib.path
        assert path.parent == common.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(lib.source.stem + "-")
        assert path == lib.path                    # stable
    assert FLASH_LIB.path != CHAIN_LIB.path
    assert "sm_90a" in " ".join(common.NVCC_FLAGS)


@pytest.mark.parametrize("source,replaces", [
    ("flashattn.cu", "repro/kernels/flashattn/flashattn.py: flash_attention"),
    ("chain.cu", "repro/kernels/streamfuse/chain.py: fused_matmul_chain"),
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
