"""The port's CNN path against the JAX reference, on the CPU.

* ``fused_pad_conv_relu``: on CPU tensors the wrapper runs its plain
  version, which meets the JAX Pallas kernel in interpret mode and both
  packages' ``pad_conv_relu_ref`` oracles on the same seeded inputs, at
  the reference sweep's 1e-4 (rtol and atol) in float32 and 2e-2 in
  bfloat16 — the sweep's shapes (``tests/test_kernels.py``) and ragged
  ones (K = 5 and 7, C = 3, widths no tile divides).
* Routing: ``route_plan`` equal to the reference's on the CNN workloads,
  by default and forced, and the fitted ``"cuda"`` gate's plan at
  ResNet-18's and VGG-16's published 224 × 224 shape (planning only).
* The eager frontend and ``params_from_numpy`` on conv weights.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import codo_torch  # noqa: E402
from repro.core.compiler import codo_opt as ref_codo_opt  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.kernels.streamfuse.ref import \
    pad_conv_relu_ref as jax_conv_ref  # noqa: E402
from repro.kernels.streamfuse.streamfuse import \
    fused_pad_conv_relu as jax_conv  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import ops, routing  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.kernels.streamfuse import (CONV_LIBRARY,  # noqa: E402
                                            fused_pad_conv_relu,
                                            pad_conv_relu_plain,
                                            pad_conv_relu_ref)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.streamfuse.streamfuse import (  # noqa: E402
    CONV_BN, CONV_STAGE, CONV_WIDE_DEPTH, conv_launches, conv_splits,
    conv_tile_rows)
from repro_torch.models import dataflow_models as dm  # noqa: E402

CONV_TOL = dict(rtol=1e-4, atol=1e-4)      # the reference sweep's band
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# (N, C, H, W, CO, K): the reference sweep (tests/test_kernels.py), then
# ragged shapes — K = 5 and 7, three input channels, widths and heights
# that no tile divides.
SWEEP = [(1, 3, 16, 16, 8, 3), (2, 4, 8, 12, 4, 5), (1, 8, 24, 24, 16, 3)]
RAGGED = [(1, 3, 9, 7, 5, 7), (2, 3, 5, 13, 6, 5)]
# ResNet-18's five routed chains at 224 x 224: (C = CO, H = W), K = 3.
RESNET_ROUTES = [(64, 56), (64, 56), (128, 28), (256, 14), (512, 7)]


def _conv_operands(N, C, H, W, CO, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((CO, C, K, K)) * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("N,C,H,W,CO,K", SWEEP + RAGGED)
def test_conv_plain_matches_jax_kernel_and_oracles(N, C, H, W, CO, K):
    x, w = _conv_operands(N, C, H, W, CO, K)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = fused_pad_conv_relu(tx, tw)
    assert got.shape == (N, CO, H, W) and got.dtype == torch.float32
    torch.testing.assert_close(got, pad_conv_relu_plain(tx, tw), rtol=0,
                               atol=0)
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w),
                               interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_conv_ref(
        jnp.asarray(x), jnp.asarray(w))), **CONV_TOL)
    np.testing.assert_allclose(pad_conv_relu_ref(tx, tw).numpy(), want,
                               **CONV_TOL)


def test_conv_plain_bf16_matches_jax_kernel():
    """bfloat16 operands, float32 sums, a bfloat16 result — as the TPU
    kernel computes it."""
    x, w = _conv_operands(2, 4, 8, 12, 4, 5, seed=1)
    got = fused_pad_conv_relu(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    want = jax_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                    interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_conv_cpu_tensors_launch_nothing():
    before = CONV_LIBRARY.launches
    x, w = map(torch.from_numpy, _conv_operands(1, 3, 6, 6, 4, 3))
    fused_pad_conv_relu(x, w)
    assert CONV_LIBRARY.launches == before and CONV_LIBRARY._lib is None


def test_conv_rejects_bad_operands():
    x = torch.zeros(1, 3, 6, 6)
    with pytest.raises(ValueError, match="odd"):
        fused_pad_conv_relu(x, torch.zeros(4, 3, 2, 2))
    with pytest.raises(ValueError, match="channels"):
        fused_pad_conv_relu(x, torch.zeros(4, 2, 3, 3))
    with pytest.raises(ValueError, match="N, C, H, W"):
        fused_pad_conv_relu(x[0], torch.zeros(4, 3, 3, 3))
    with pytest.raises(TypeError):
        fused_pad_conv_relu(x, torch.zeros(4, 3, 3, 3).double())


@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("C,H", RESNET_ROUTES[1:])
def test_conv_splits_cover_the_window(N, C, H):
    """The window splits into whole 32-deep stages, none empty; the deep
    stages at N = 1 (few tiles of 128 pixels by 64 or 128 channels) split
    until their blocks cover at least two thirds of the card's SMs (the
    fitted cost can prefer one block on each of fewer SMs to two on some);
    the 128-channel tile's splits are at most CONV_WIDE_DEPTH deep."""
    shape_x, shape_w = (N, C, H, H), (C, C, 3, 3)
    splits, per = conv_splits(shape_x, shape_w)
    depth = C * 9
    assert per % CONV_STAGE == 0 and CONV_STAGE == 32
    assert per * (splits - 1) < depth <= per * splits
    rows = conv_tile_rows(C)
    assert rows == (64 if C == 64 else 128) and CONV_BN == 128
    if rows == 128:
        assert per <= CONV_WIDE_DEPTH == 512
    tiles = -(-C // rows) * -(-N * H * H // CONV_BN)
    if N == 1:
        assert tiles * splits >= 2 * 132 // 3
    assert conv_launches(shape_x, shape_w) == (1 if splits == 1 else 2)


# Every routed chain of ResNet-18 and VGG-16 at 224 x 224, (C, CO, H = W).
ROUTE_SHAPES = sorted({(C, C, H) for C, H in RESNET_ROUTES} | {
    (3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
    (128, 256, 56), (256, 256, 56), (256, 512, 28), (512, 512, 28),
    (512, 512, 14)})


def _cu_tiles():
    """pad_conv_relu.cu's two tiles as the source declares them, by
    output channels a block: (BM, BN, WM, WN, STAGES), and the stage depth
    BK of mma_gemm.cuh."""
    import re
    src = (common.CSRC / "pad_conv_relu.cu").read_text()
    tiles = {}
    for name in ("NarrowTile", "WideTile"):
        decl = re.search(rf"using {name} = TileShape<([\d, ]+)>;", src)
        shape = tuple(int(v) for v in decl.group(1).split(","))
        tiles[shape[0]] = shape
    bk = re.search(r"constexpr int BK = (\d+);",
                   (common.CSRC / "mma_gemm.cuh").read_text())
    return tiles, int(bk.group(1))


@pytest.mark.parametrize("C,CO,H", ROUTE_SHAPES)
def test_conv_tile_fits_two_blocks_and_rows_are_vectors(C, CO, H):
    """The tile the wrapper picks for the route is one pad_conv_relu.cu
    declares, of 128 pixels and 8 warps.  In float32 and bfloat16 two of
    its blocks fit a SM's shared memory (each also reserves 1 KB: the
    three-stage ring of the weight and window tiles, both kept k-minor,
    or the float32 output tile after it), and every row of both tiles is
    whole 16-byte vectors (cp.async, ldmatrix), as the source's
    static_assert demands when it builds; the route's window splits into
    whole 32-deep stages."""
    tiles, bk = _cu_tiles()
    rows = conv_tile_rows(CO)
    BM, BN, WM, WN, stages = tiles[rows]
    assert (BN, bk) == (CONV_BN, CONV_STAGE)
    assert 32 * (BM // WM) * (BN // WN) == 256
    for itemsize in (4, 2):
        ld = bk + 16 // itemsize                 # mma_gemm.cuh k_ld
        smem = max(itemsize * stages * (BM + BN) * ld, 4 * BM * (BN + 8))
        assert 2 * (smem + 1024) <= common.SMEM_PER_SM
        assert ld * itemsize % 16 == 0
    splits, per = conv_splits((1, C, H, H), (CO, C, 3, 3))
    assert per % CONV_STAGE == 0 and (splits - 1) * per < C * 9


def test_conv_plan_is_kept_per_shape():
    """The launch plan's search runs once a shape: a second call of the
    same route is a cache hit."""
    conv_splits.cache_clear()
    conv_launches((1, 512, 7, 7), (512, 512, 3, 3))
    conv_launches(torch.Size((1, 512, 7, 7)), (512, 512, 3, 3))
    info = conv_splits.cache_info()
    assert (info.misses, info.hits) == (1, 1)


def test_full_f32_convolutions_overrides_the_global_flag():
    """cuDNN's float32 convolutions default to TF32; the conv2d body and
    the oracle run under a context that turns it off whatever the global
    flag says, and restores the flag after."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        with ops.full_f32_convolutions():
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = before


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

CNN = {
    "resnet18": ("resnet18_fn", [(1, 3, 8, 8)]),
    "resnet18_32": ("resnet18_fn", [(1, 3, 32, 32)]),
    "vgg16": ("vgg16_fn", [(1, 3, 32, 32)]),
    "conv3_block": ("conv3_block_fn", [(1, 3, 14, 14)]),
    "residual_block": ("residual_block_fn", [(1, 8, 12, 12)]),
    "dws_conv_block": ("dws_conv_block_fn", [(1, 8, 12, 12)]),
}


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", sorted(CNN))
def test_cnn_route_plan_matches_reference(name, forced, monkeypatch):
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    fn, shapes = CNN[name]
    a = codo_opt(dm.trace(getattr(dm, fn), *shapes, name=name), cache=None)
    b = ref_codo_opt(ref_dm.trace(getattr(ref_dm, fn), *shapes, name=name),
                     cache=None)
    plan = routing.route_plan(a.graph, a.buffer_plan.impl)
    assert plan == ref_route_plan(b.graph, b.buffer_plan.impl)
    if forced and name == "vgg16":
        assert Counter(g["kernel"] for g in plan if g["routes"]) == {
            "pallas:streamfuse.conv": 13, "pallas:streamfuse.mmchain": 1}


@pytest.mark.parametrize("name,want", [
    ("resnet18", {"pallas:streamfuse.conv": 5}),
    ("vgg16", {"pallas:streamfuse.conv": 13}),
])
def test_cuda_backend_routes_the_conv_chains_at_224(name, want, monkeypatch):
    """Planning only: the fitted ``cuda`` gate at the published 224 x 224
    ImageNet shape routes ResNet-18's five stride-1 pad → conv → relu
    chains and VGG-16's thirteen; VGG-16's fc → relu → fc head still
    matches, and the gate declines it (the chain lost to cuBLAS on the
    card, PERF.md §6)."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    monkeypatch.delenv("CODO_DISABLE_PALLAS", raising=False)
    c = codo_opt(getattr(dm, name)(224), cache=None)
    plan = routing.route_plan(c.graph, c.buffer_plan.impl)
    routed = [g for g in plan if g["routes"]]
    assert Counter(g["kernel"] for g in routed) == want
    assert {r["decision"] for g in routed for r in g["routes"]} == {
        "predicted-win"}
    rejected = [(r["kernel"], r["decision"]) for g in plan
                for r in g["rejected"]]
    assert rejected == ([("streamfuse.mmchain", "predicted-loss")]
                        if name == "vgg16" else [])
    if name == "resnet18":
        # the 56, 56, 28, 14 and 7 stride-1 chains, CO = C = 64..512
        chains = [r["tasks"] for g in routed for r in g["routes"]]
        outs = [c.graph.task(ts[-1]).spec.outs[0] for ts in chains]
        shapes = [c.graph.buffers[o].shape for o in outs]
        assert [(s[1], s[2]) for s in shapes] == RESNET_ROUTES


# --------------------------------------------------------------------------
# frontend and weights
# --------------------------------------------------------------------------


def test_eager_resnet18_matches_reference():
    """Eager ``F`` calls on tensors (shape-keyed ``weight_init`` in both
    packages) against the reference's eager run, band 1e-5."""
    x = np.random.default_rng(5).standard_normal((1, 3, 8, 8)).astype(
        np.float32)
    got = dm.resnet18_fn(torch.from_numpy(x))
    want = np.asarray(ref_dm.resnet18_fn(x))
    assert got.shape == want.shape == (1, 1000)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_params_from_numpy_carries_conv_weights_unchanged():
    """The reference's conv weights are OIHW, as the port's are: they
    carry across as they are, bit for bit, and the compiled ResNet-18
    gives the reference's answer with them."""
    import codo
    ours = codo_torch.compile(dm.resnet18_fn, (1, 3, 8, 8), device="cpu")
    theirs = codo.compile(ref_dm.resnet18_fn, (1, 3, 8, 8))
    ref_graph = theirs.graph
    ws = {k: v for k, v in dm.random_inputs(ours.graph, seed=3).items()
          if ours.graph.buffers[k].kind == "weight"}
    convs = [k for k, v in ws.items() if v.ndim == 4]
    assert len(convs) == 20
    got = codo_torch.params_from_numpy(ws, ours.graph, "cpu")
    for k in convs:
        assert tuple(ref_graph.buffers[k].shape) == ws[k].shape
        np.testing.assert_array_equal(got[k].numpy(), ws[k])
    ours.bind(**got)
    theirs.bind(**ws)
    x = np.random.default_rng(4).standard_normal((1, 3, 8, 8)).astype(
        np.float32)
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(theirs(x)),
                               rtol=1e-5, atol=1e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Doubled:
    """A lowered program whose every answer is twice the right one: an
    error as large as the answer."""

    def __init__(self, low):
        self.low, self.groups = low, low.groups

    def __call__(self, env):
        return {k: 2 * v for k, v in self.low(env).items()}


@pytest.mark.parametrize("broken", [False, True])
def test_first_run_holds_mobilenet_to_its_output_scale(broken, monkeypatch):
    """``chip_smoke.py: first_run`` on the CPU: mobilenet at 224 on its
    seed answers at ~1.3e-4, so the absolute verify band of 1e-4 covers
    most of any answer and only an error held to the output's scale can
    fail; an answer twice the right one must fail it."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    program = codo_torch.compile(dm.mobilenet_fn, (1, 3, 224, 224),
                                 device="cpu")
    if broken:
        real = program.lower
        monkeypatch.setattr(program, "lower",
                            lambda jit=True: _Doubled(real(jit=jit)))
        with pytest.raises(SystemExit):
            cs.first_run("mobilenet N=1", program)
        return
    got = cs.first_run("mobilenet N=1", program)
    assert got["verify_scale"] < 2 * cs.VERIFY_BAND
    assert got["routed_groups"] == []               # nothing routes at 224
    assert got["verify_rel_err"] == got["verify_max_abs_err"] \
        / got["verify_scale"] <= cs.VERIFY_BAND
