"""The PyTorch port against the JAX reference: structure, passes, routing.

The port copies the framework-free compiler (graph IR, six passes, cost
model, cache, routing), so a traced function must give the reference's
structural hash, ``codo_opt`` the reference's modeled cycles and FIFO
fraction, and ``route_plan`` the reference's routing table.  Small shapes
throughout; nothing here executes a kernel.
"""

import math
import sys

import pytest

pytest.importorskip("torch")

from repro.core.compiler import codo_opt as ref_codo_opt  # noqa: E402
from repro.core.routing import route_plan as ref_route_plan  # noqa: E402
from repro.models import dataflow_models as ref_dm  # noqa: E402
from repro_torch.core import costmodel, routing  # noqa: E402
from repro_torch.core.compiler import codo_opt  # noqa: E402
from repro_torch.models import dataflow_models as dm  # noqa: E402

# Workloads compiled by both packages at test scale.
SMALL = {
    "gpt2_block": ("gpt2_block_fn", [(16, 64)]),
    "gpt2_block_loss": ("gpt2_block_loss_fn", [(16, 64), (16, 64)]),
    "resnet18": ("resnet18_fn", [(1, 3, 8, 8)]),
    "atax": ("atax_fn", [(48, 40), (40,)]),
    "gesummv": ("gesummv_fn", [(40, 40), (40, 40), (40,)]),
    "gemm": ("gemm_fn", [(24, 16), (16, 20)]),
    "mvt": ("mvt_fn", [(40, 40), (40,), (40,)]),
    "3mm": ("three_mm_fn", [(16, 16)] * 4),
    "residual_mlp": ("residual_mlp_fn", [(8, 32)]),
    "autoencoder": ("autoencoder_fn", [(8, 64)]),
    "residual_block": ("residual_block_fn", [(1, 8, 12, 12)]),
    "dws_conv_block": ("dws_conv_block_fn", [(1, 8, 12, 12)]),
    "conv3_block": ("conv3_block_fn", [(1, 3, 14, 14)]),
    "feed_forward": ("feed_forward_fn", [(16, 32)]),
    "multi_head_attention": ("multi_head_attention_fn", [(24, 32)]),
}


def _traced(name):
    fn, shapes = SMALL[name]
    ours = dm.trace(getattr(dm, fn), *shapes, name=name)
    theirs = ref_dm.trace(getattr(ref_dm, fn), *shapes, name=name)
    return ours, theirs


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_hash_matches_reference(name):
    ours, theirs = _traced(name)
    assert ours.structural_signature() == theirs.structural_signature()
    assert ours.structural_hash() == theirs.structural_hash()


@pytest.mark.parametrize("name", sorted(dm.HANDBUILT_BENCHES))
def test_paper_sized_builders_match_reference(name):
    """Both halves of every hand-built pair the port carries, at the
    paper's default sizes."""
    traced, hand = dm.HANDBUILT_BENCHES[name]
    ref_traced, ref_hand = ref_dm.HANDBUILT_BENCHES[name]
    assert traced().structural_hash() == ref_traced().structural_hash()
    assert hand().structural_hash() == ref_hand().structural_hash()


def test_kernel_benches_match_reference():
    assert set(dm.KERNEL_BENCHES) == set(ref_dm.KERNEL_BENCHES)
    for name, build in dm.KERNEL_BENCHES.items():
        assert build().structural_hash() == \
            ref_dm.KERNEL_BENCHES[name]().structural_hash(), name


@pytest.mark.parametrize("name", sorted(SMALL))
def test_codo_opt_matches_reference(name):
    ours, theirs = _traced(name)
    a = codo_opt(ours, cache=None)
    b = ref_codo_opt(theirs, cache=None)
    assert a.final.total_cycles == b.final.total_cycles
    assert a.baseline.total_cycles == b.baseline.total_cycles
    assert a.fifo_fraction == b.fifo_fraction
    assert a.graph.structural_hash() == b.graph.structural_hash()
    assert a.buffer_plan.impl == b.buffer_plan.impl


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("name", ["gpt2_block", "multi_head_attention",
                                  "feed_forward", "gpt2_block_loss"])
def test_route_plan_matches_reference(name, forced, monkeypatch):
    if forced:
        monkeypatch.setenv("CODO_FORCE_PALLAS", "1")
    ours, theirs = _traced(name)
    a = codo_opt(ours, cache=None)
    b = ref_codo_opt(theirs, cache=None)
    plan = routing.route_plan(a.graph, a.buffer_plan.impl)
    ref_plan = ref_route_plan(b.graph, b.buffer_plan.impl)
    assert plan == ref_plan
    if forced and name == "gpt2_block":
        assert [g["kernel"] for g in plan] == [
            "pallas:flashattn.mha+streamfuse.mmchain"]


def test_cuda_backend_routes_both_chains_at_full_width(monkeypatch):
    """Planning only: both chains of the GPT-2-medium-width block still
    match at full width on the ``cuda`` backend (no TPU budget drops
    them), and the fitted gate declines both — flash and the FFN chain
    lost to the generic path on the card (PERF.md §6)."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    c = codo_opt(dm.gpt2_block(128, 1024), cache=None)
    plan = routing.route_plan(c.graph, c.buffer_plan.impl)
    assert [g["kernel"] for g in plan] == ["xla-fused"]
    (group,) = plan
    assert group["routes"] == []
    assert [(r["kernel"], r["decision"]) for r in group["rejected"]] == [
        ("flashattn.mha", "predicted-loss"),
        ("streamfuse.mmchain", "predicted-loss")]
    assert len(group["tasks"]) == 17


def test_routing_backend_follows_device(monkeypatch):
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    assert costmodel.routing_backend() == "cpu"
    assert costmodel.routing_backend("cpu") == "cpu"
    assert costmodel.routing_backend("cuda:0") == "cuda"
    monkeypatch.setenv("CODO_BACKEND", "tpu")
    assert costmodel.routing_backend("cuda") == "tpu"


# The autotune records the "cuda" gate is fitted from: every matched chain
# of chip_smoke.py's paths timed routed and generic (best-of walls, ms, each
# form captured into a CUDA graph as a jit=True program runs it) on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), as
# (pattern, routed_ms, generic_ms) in the order the routing fit took them.
CUDA_FIT_RECORDS = [
    ('flashattn.mha', 0.1175, 0.107),
    ('streamfuse.mmchain', 0.1957, 0.1436),
    ('flashattn.mha', 0.3819, 0.2202),
    ('streamfuse.mmchain', 0.5569, 0.4589),
    ('flashattn.mha', 0.1247, 0.1022),
    ('streamfuse.mmgrad', 0.0996, 0.1324),
    ('streamfuse.mmgrad', 0.1077, 0.1062),
    ('streamfuse.mmgrad', 0.2958, 0.4929),
    ('streamfuse.mmgrad', 0.1561, 0.1548),
    ('streamfuse.conv', 0.0994, 0.104),
    ('streamfuse.conv', 0.0947, 0.0925),
    ('streamfuse.conv', 0.0611, 0.0744),
    ('streamfuse.conv', 0.0654, 0.1078),
    ('streamfuse.conv', 0.0943, 0.1795),
    ('streamfuse.conv', 0.127, 0.1831),
    ('streamfuse.conv', 0.1291, 0.1832),
    ('streamfuse.conv', 0.1223, 0.1766),
    ('streamfuse.conv', 0.1061, 0.1548),
    ('streamfuse.conv', 0.1154, 0.1878),
    ('streamfuse.conv', 0.0896, 0.0913),
    ('streamfuse.conv', 0.1898, 0.2129),
    ('streamfuse.conv', 0.1149, 0.1379),
    ('streamfuse.conv', 0.1542, 0.2045),
    ('streamfuse.conv', 0.1085, 0.138),
    ('streamfuse.conv', 0.1499, 0.2124),
    ('streamfuse.conv', 0.1474, 0.2081),
    ('streamfuse.conv', 0.1125, 0.1613),
    ('streamfuse.conv', 0.1516, 0.2548),
    ('streamfuse.conv', 0.1563, 0.2588),
    ('streamfuse.conv', 0.0926, 0.1724),
    ('streamfuse.conv', 0.1025, 0.1811),
    ('streamfuse.conv', 0.1048, 0.1804),
    ('streamfuse.mmchain', 0.1213, 0.1215),
    ('rglru.scan', 0.3198, 10.1087),
    ('ssd.scan', 0.1612, 0.2812),
    ('flashattn.mha', 2.3608, 2.0113),
    ('streamfuse.softmaxmm', 0.0923, 0.0954),
    ('streamfuse.softmaxmm', 0.1325, 0.1349),
    ('streamfuse.conv', 0.1418, 0.145),
    ('streamfuse.conv', 0.1465, 0.1717),
    ('streamfuse.conv', 0.1064, 0.1516),
    ('streamfuse.mmchain', 0.4015, 0.3703),
    ('streamfuse.conv', 0.1735, 0.1797),
    ('streamfuse.conv', 0.1689, 0.1541),
    ('streamfuse.conv', 0.1068, 0.1199),
    ('streamfuse.conv', 0.0994, 0.115),
    ('streamfuse.conv', 0.1534, 0.1599),
    ('streamfuse.conv', 0.0912, 0.1167),
    ('streamfuse.conv', 0.0991, 0.175),
]


def test_cuda_routing_params_start_neutral():
    """The ``cuda`` gate's constants are no longer neutral: they are
    ``calibrate_routing_params`` of the card's autotune records, with no
    spill and no overlap."""
    p = costmodel.DEFAULT_ROUTING_PARAMS["cuda"]
    assert p.generic_spill == 0.0 and p.stream_overlap == 0.0
    doc = {"backend": "cuda",
           "records": [{"kernel": k, "speedup": g / r}
                       for k, r, g in CUDA_FIT_RECORDS]}
    fit = costmodel.calibrate_routing_params(doc)
    assert fit == p
    assert {k for k, _ in p.efficiency} == {k for k, _, _ in CUDA_FIT_RECORDS}
    assert p.eff("rglru.scan") == 2.0                             # clamped
    assert p.eff("ssd.scan") > p.eff("streamfuse.conv") \
        > p.eff("streamfuse.mmgrad") > p.eff("streamfuse.softmaxmm") > 1.0
    assert max(p.eff("flashattn.mha"), p.eff("streamfuse.mmchain")) < 1.0


def test_h100_params_and_v5e_default():
    h = costmodel.H100
    assert h.name == "h100-sxm" and h.hbm_bw == 3.35e12
    fp32 = h.max_units * h.unit_flops_per_cycle * h.clock_hz
    assert math.isclose(fp32, 66.9e12, rel_tol=0.01)   # data sheet: 67 TFLOP/s
    from repro_torch.core.compiler import CodoOptions
    assert CodoOptions().hw == costmodel.V5E


def test_kernel_registration_failure_raises(monkeypatch):
    """The reference swallows an ImportError here and routes nothing; the
    port must fail loudly instead."""
    import repro_torch
    monkeypatch.setattr(routing, "_WIRED", False)
    monkeypatch.delattr(repro_torch, "kernels", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.kernels", None)
    with pytest.raises(ImportError):
        routing.ensure_kernel_patterns()
    assert routing._WIRED is False
