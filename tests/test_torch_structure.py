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
    """Planning only: the neutral ``cuda`` gate routes both chains of the
    GPT-2-medium-width block, as the reference's gate does on CPU."""
    monkeypatch.setenv("CODO_BACKEND", "cuda")
    monkeypatch.delenv("CODO_FORCE_PALLAS", raising=False)
    c = codo_opt(dm.gpt2_block(128, 1024), cache=None)
    plan = routing.route_plan(c.graph, c.buffer_plan.impl)
    assert [g["kernel"] for g in plan] == [
        "pallas:flashattn.mha+streamfuse.mmchain"]
    (group,) = plan
    assert {r["decision"] for r in group["routes"]} == {"predicted-win"}
    assert len(group["tasks"]) == 17


def test_routing_backend_follows_device(monkeypatch):
    monkeypatch.delenv("CODO_BACKEND", raising=False)
    assert costmodel.routing_backend() == "cpu"
    assert costmodel.routing_backend("cpu") == "cpu"
    assert costmodel.routing_backend("cuda:0") == "cuda"
    monkeypatch.setenv("CODO_BACKEND", "tpu")
    assert costmodel.routing_backend("cuda") == "tpu"


def test_cuda_routing_params_start_neutral():
    p = costmodel.DEFAULT_ROUTING_PARAMS["cuda"]
    assert p.generic_spill == 0.0 and p.stream_overlap == 0.0
    assert {e for _, e in p.efficiency} == {1.0}
    assert p.eff("flashattn.mha") == p.eff("streamfuse.mmchain") == 1.0


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
