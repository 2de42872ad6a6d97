"""Paper-benchmark workloads as CODO dataflow graphs (§VIII).

The PyTorch port's copy of ``repro/models/dataflow_models.py``: the
framework-free builders (the Table II kernels, the CNNs, the GPT-2 block,
the attention/recurrence routing workloads and the hand-built twins).  The
architecture-config block graphs wait for the LM stack.

Every workload the paper evaluates is defined here — since the
traced-function frontend (:mod:`repro_torch.core.frontend`) landed, the Table II
kernels and **every** DNN (ResNet-18, VGG-16, MobileNet, ZFNet,
YOLO-tiny, the GPT-2 block) plus the attention/recurrence routing
workloads are **plain Python functions** over symbolic
:class:`~repro_torch.core.frontend.ShapedBuffer` arguments, traced into graphs
by :func:`~repro_torch.core.frontend.trace`.  Only the architecture-config
block graphs still use the low-level :class:`~repro_torch.core.frontend.GB`
builder directly — the documented escape hatch for graphs that want
manual control.

Both roads emit identical structure: a traced builder and its hand-built
twin produce the same ``structural_hash`` — the same compile-cache key —
which the ``HANDBUILT_BENCHES`` references at the bottom of this file
exist to prove (tests/test_frontend.py).  Each task carries a declarative
:class:`~repro_torch.core.ops.OpSpec`, so compiled designs stay portable
artifacts: graphs built here survive the disk compile cache and
process-pool batch compiles fully executable.  Building graphs does not
import torch, except the three whose bodies live beside the LM stack
(``mha_batched``, ``rglru_block``, ``ssd_block``: their modules are torch
code); executing any graph does.

* Table II kernels: atax, gesummv, gemm, mvt, 3mm, residual-mlp,
  autoencoder, residual-block, dws-conv block, 3-layer conv, feed-forward,
  multi-head attention.
* Tables III/IV DNNs: ResNet-18, VGG-16, MobileNet(v1), ZFNet, YOLO-tiny —
  parameterized by input size (3×32×32 / 3×224×224 / 3×1280×384).
* GPT-2 block graph (Fig. 9 / Table VI workload).

Residual skips produce the single-producer-multi-consumer bypass pattern
(Fig. 4a); init/pad pairs produce multi-producer patterns; conv windows
produce stencil re-reads; matmul/pool reductions produce count mismatches —
i.e. these graphs exercise every violation class the paper names.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import frontend as F
from ..core.frontend import GB, trace  # noqa: F401  (GB re-exported: legacy API)
from ..core.graph import DataflowGraph

# --------------------------------------------------------------------------
# Table II kernel-level applications — traced functions.  The *_fn bodies
# are the workload definitions (plain Python over ShapedBuffers; they also
# run eagerly on concrete arrays); the same-named public builders trace
# them at the paper's default sizes.  All are module-level, hence picklable
# for the process-pool batch driver.
# --------------------------------------------------------------------------


def atax_fn(A, x):
    tmp = F.mv(A, x)
    return F.mv(A, tmp, trans=True)


def atax(N: int = 400, M: int = 400) -> DataflowGraph:
    return trace(atax_fn, (M, N), (N,), name="atax")


def gesummv_fn(A, B, x):
    t1 = F.mv(A, x)
    t2 = F.mv(B, x)
    return F.vadd(t1, t2, alpha=1.5, beta=1.2)


def gesummv(N: int = 400) -> DataflowGraph:
    return trace(gesummv_fn, (N, N), (N, N), (N,), name="gesummv")


def gemm_fn(A, B):
    return F.scale(F.matmul(A, B), 1.5)


def gemm(M: int = 256, N: int = 256, K: int = 256) -> DataflowGraph:
    return trace(gemm_fn, (M, K), (K, N), name="gemm")


def mvt_fn(A, y1, y2):
    x1 = F.mv(A, y1)
    x2 = F.mv(A, y2, trans=True)
    return F.vadd(x1, x2)


def mvt(N: int = 400) -> DataflowGraph:
    return trace(mvt_fn, (N, N), (N,), (N,), name="mvt")


def three_mm_fn(A, B, C, D):
    E = F.matmul(A, B)
    Fm = F.matmul(C, D)
    return F.matmul(E, Fm)


def three_mm(M: int = 256) -> DataflowGraph:
    return trace(three_mm_fn, (M, M), (M, M), (M, M), (M, M), name="3mm")


def residual_mlp_fn(x):
    """h = relu(fc(x)); out = relu(fc(h) + x) — the bypass pattern
    (Fig. 4a): x feeds both the first fc and the skip add."""
    D = x.shape[1]
    x = F.load(x)
    h = F.fc(x, D, relu=True)
    h2 = F.fc(h, D)
    return F.relu(F.add(h2, x))


def residual_mlp(B: int = 64, D: int = 512) -> DataflowGraph:
    return trace(residual_mlp_fn, (B, D), name="residual_mlp")


def autoencoder_fn(x):
    D = x.shape[1]
    h = F.fc(x, 256, relu=True)
    h = F.fc(h, 64, relu=True)
    h = F.fc(h, 256, relu=True)
    return F.fc(h, D)


def autoencoder(B: int = 64, D: int = 784) -> DataflowGraph:
    return trace(autoencoder_fn, (B, D), name="autoencoder")


def residual_block_fn(x):
    C = x.shape[1]
    x = F.load(x)
    h = F.conv(x, C, 3, relu=True)
    h = F.conv(h, C, 3, relu=False)
    return F.relu(F.add(h, x))       # skip: SPMC on x


def residual_block(N: int = 1, C: int = 64, H: int = 32) -> DataflowGraph:
    return trace(residual_block_fn, (N, C, H, H), name="residual_block")


def dws_conv_block_fn(x):
    C = x.shape[1]
    h = F.conv(x, C, 3, depthwise=True)
    return F.conv(h, 2 * C, 1, pad=0)


def dws_conv_block(N: int = 1, C: int = 64, H: int = 32) -> DataflowGraph:
    return trace(dws_conv_block_fn, (N, C, H, H), name="dwsconv")


def conv3_block_fn(x):
    h = F.conv(x, 32, 3)
    h = F.conv(h, 32, 3)
    return F.conv(h, 64, 3)


def conv3_block(N: int = 1, C: int = 3, H: int = 34) -> DataflowGraph:
    return trace(conv3_block_fn, (N, C, H, H), name="conv3")


def feed_forward_fn(x):
    D = x.shape[1]
    h = F.fc(x, 4 * D)
    h = F.gelu(h)
    return F.fc(h, D)


def feed_forward(B: int = 128, D: int = 512) -> DataflowGraph:
    return trace(feed_forward_fn, (B, D), name="feed_forward")


def multi_head_attention_fn(x):
    """Single-head attention core (the multi-head loop is the batch ring):
    x feeds Q/K/V projections (SPMC), Q@K^T needs a transpose (order
    violation), softmax is the reduction producer."""
    D = x.shape[1]
    q = F.fc(x, D)
    k = F.fc(x, D)
    v = F.fc(x, D)
    kt = F.transpose(k)
    s = F.matmul(q, kt)
    s = F.scale(s, 1.0 / math.sqrt(D))
    p = F.softmax(s)
    att = F.matmul(p, v)
    return F.fc(att, D)


def multi_head_attention(S: int = 128, D: int = 256) -> DataflowGraph:
    return trace(multi_head_attention_fn, (S, D), name="mha")


# --------------------------------------------------------------------------
# DNN models (Tables III/IV)
# --------------------------------------------------------------------------


def resnet18_fn(x):
    H = x.shape[2]
    if H >= 224:
        h = F.conv(x, 64, 7, stride=2, pad=3)
        h = F.maxpool(h, 2)
    else:
        h = F.conv(x, 64, 3)
    for stage, (c, blocks) in enumerate([(64, 2), (128, 2), (256, 2), (512, 2)]):
        for blk in range(blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            inp = h
            h1 = F.conv(inp, c, 3, stride=stride)
            h2 = F.conv(h1, c, 3, relu=False)
            if stride != 1 or inp.shape[1] != c:
                skip = F.conv(inp, c, 1, stride=stride, pad=0, relu=False)
            else:
                skip = inp
            h = F.relu(F.add(h2, skip))
    h = F.global_avgpool(h)
    return F.fc(h, 1000)


def resnet18(H: int = 32) -> DataflowGraph:
    return trace(resnet18_fn, (1, 3, H, H), name=f"resnet18_{H}")


def vgg16_fn(x):
    h = x
    for c, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps):
            h = F.conv(h, c, 3)
        h = F.maxpool(h, 2)
    h = F.flatten(h)
    h = F.fc(h, 512, relu=True)
    h = F.fc(h, 512, relu=True)
    return F.fc(h, 1000)


def vgg16(H: int = 32) -> DataflowGraph:
    return trace(vgg16_fn, (1, 3, H, H), name=f"vgg16_{H}")


def mobilenet_fn(x):
    H = x.shape[2]
    h = F.conv(x, 32, 3, stride=2 if H >= 224 else 1)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + \
           [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    for c, s in plan:
        h = F.conv(h, 0, 3, stride=s, depthwise=True)
        h = F.conv(h, c, 1, pad=0)
    h = F.global_avgpool(h)
    return F.fc(h, 1000)


def mobilenet(H: int = 32) -> DataflowGraph:
    return trace(mobilenet_fn, (1, 3, H, H), name=f"mobilenet_{H}")


def zfnet_fn(x):
    h = F.conv(x, 96, 7, stride=2, pad=3)
    h = F.maxpool(h, 2)
    h = F.conv(h, 256, 5, stride=2, pad=2)
    h = F.maxpool(h, 2)
    h = F.conv(h, 384, 3)
    h = F.conv(h, 384, 3)
    h = F.conv(h, 256, 3)
    h = F.maxpool(h, 2)
    h = F.flatten(h)
    h = F.fc(h, 4096, relu=True)
    h = F.fc(h, 4096, relu=True)
    return F.fc(h, 1000)


def zfnet(H: int = 224) -> DataflowGraph:
    return trace(zfnet_fn, (1, 3, H, H), name=f"zfnet_{H}")


def yolo_tiny_fn(x):
    h = x
    c = 16
    for _ in range(6):
        h = F.conv(h, c, 3)
        h = F.maxpool(h, 2)
        c = min(c * 2, 512)
    h = F.conv(h, 512, 3)
    h = F.conv(h, 256, 1, pad=0)
    return F.conv(h, 255, 1, pad=0, relu=False)


def yolo_tiny(H: int = 384, W: int = 1280) -> DataflowGraph:
    return trace(yolo_tiny_fn, (1, 3, H, W), name="yolo")


def gpt2_block_fn(x):
    """One GPT-2 block: LN -> MHA(+skip) -> LN -> FF(+skip) — the repeated
    unit of the paper's GPT-2 accelerator (LN folded into projections for
    graph purposes)."""
    D = x.shape[1]
    x = F.load(x)
    q = F.fc(x, D)
    k = F.fc(x, D)
    v = F.fc(x, D)
    kt = F.transpose(k)
    s = F.scale(F.matmul(q, kt), 1.0 / math.sqrt(D // 16))
    p = F.softmax(s)
    att = F.matmul(p, v)
    proj = F.fc(att, D)
    h = F.add(proj, x)              # skip 1: SPMC on x
    f = F.fc(h, 4 * D)
    f = F.gelu(f)
    f = F.fc(f, D)
    return F.add(f, h)              # skip 2: SPMC on h


def gpt2_block(S: int = 128, D: int = 1024) -> DataflowGraph:
    return trace(gpt2_block_fn, (S, D), name="gpt2_block")


def gpt2_block_loss_fn(x, target):
    """MSE training objective over one GPT-2 block — the single (1, 1)
    loss output a ``codo.compile(..., grad=True)`` train step seeds."""
    d = F.sub(gpt2_block_fn(x), target)
    return F.mean_all(F.mul(d, d))


def gpt2_block_loss(S: int = 128, D: int = 1024) -> DataflowGraph:
    return trace(gpt2_block_loss_fn, (S, D), (S, D), name="gpt2_block_loss")


# --------------------------------------------------------------------------
# Attention / recurrence families.  The workload bodies live next to their
# reference models (models/transformer.py, rglru.py, ssm.py); the builders
# below trace them at routing-bench sizes.
# --------------------------------------------------------------------------


def mha_batched(BH: int = 4, S: int = 64, hd: int = 32) -> DataflowGraph:
    """One attention head over (BH, S, hd) operands — the batched
    matmul->scale->softmax->matmul chain the flashattn pattern routes."""
    from .transformer import mha_batched_fn
    sh = (BH, S, hd)
    return trace(mha_batched_fn, sh, sh, sh, name="mha_batched")


def rglru_block(B: int = 2, S: int = 128, D: int = 64) -> DataflowGraph:
    """Gated linear recurrence + residual (RG-LRU core)."""
    from .rglru import rglru_block_fn
    sh = (B, S, D)
    return trace(rglru_block_fn, sh, sh, sh, name="rglru_block")


def ssd_block(nc: int = 8, BH: int = 8, P: int = 32, N: int = 32) -> DataflowGraph:
    """SSD inter-chunk state recurrence + residual combine."""
    from .ssm import ssd_block_fn
    return trace(ssd_block_fn, (nc, BH, P, N), (nc, BH, 1, 1),
                 name="ssd_block")


# --------------------------------------------------------------------------
# Architecture configs -> dataflow graphs (the batch-compile grid)
# --------------------------------------------------------------------------


def _attn_block(b: GB, x: str, D: int, hd: int, enc: str | None = None) -> str:
    """Self- (or, given ``enc``, cross-) attention + projection + residual."""
    q = b.fc(x, D)
    kv_src = enc if enc is not None else x
    k = b.fc(kv_src, D)
    v = b.fc(kv_src, D)
    kt = b.transpose(k)
    s = b.scale(b.matmul(q, kt), 1.0 / math.sqrt(max(hd, 1)))
    p = b.softmax(s)
    att = b.matmul(p, v)
    proj = b.fc(att, D)
    return b.add(proj, x)                  # residual: SPMC on x


def _ffn_block(b: GB, x: str, cfg) -> str:
    """(Gated) FFN + residual; MoE adds the router dispatch/combine
    side-chain so expert traffic shows up in the dataflow."""
    D = cfg.d_model
    if cfg.glu:
        gate = b.gelu(b.fc(x, cfg.d_ff))
        up = b.fc(x, cfg.d_ff)
        mixed = b.add(gate, up)            # gating proxy (same dataflow shape)
    else:
        mixed = b.gelu(b.fc(x, cfg.d_ff))
    down = b.fc(mixed, D)
    out = b.add(down, x)
    if cfg.moe is not None:
        router = b.softmax(b.fc(x, cfg.moe.num_experts))
        combined = b.fc(router, D)         # combine back into the stream
        out = b.add(out, combined)
    return out


def _recurrent_block(b: GB, x: str, D: int, expand: int = 2) -> str:
    """SSM / RG-LRU style block: in-proj + gate, state mixing, out-proj,
    residual.  The chunked recurrence appears as a dense state-mix task —
    the dataflow (streams, reuse, reductions) is what the compiler sees."""
    d_in = D * max(expand, 1)
    u = b.fc(x, d_in)
    gate = b.gelu(b.fc(x, d_in))
    mix = b.fc(u, d_in)
    gated = b.add(mix, gate)
    out = b.fc(gated, D)
    return b.add(out, x)


def arch_block_graph(cfg, S: int = 64) -> DataflowGraph:
    """One representative backbone block of ``cfg`` (an
    :class:`repro_torch.configs.base.ArchConfig`) as a CODO dataflow graph.

    This is the unit the batch compiler drives across the opt1..opt5 grid:
    real model dims (d_model/d_ff/experts), one block per distinct kind in
    the architecture's pattern.  Multimodal prefixes are folded into ``S``
    upstream — the dataflow structure is identical.
    """
    b = GB(cfg.name.replace("-", "_").replace(".", "_"))
    D = cfg.d_model
    x = b.load(b.input("x", (S, D)))
    h = x
    if cfg.ssm is not None:
        h = _recurrent_block(b, h, D, cfg.ssm.expand)
    elif "rglru" in cfg.block_pattern:      # hybrid: recurrent + local attn
        h = _recurrent_block(b, h, D)
        h = _attn_block(b, h, D, cfg.hd)
    else:
        h = _attn_block(b, h, D, cfg.hd)
    if cfg.enc_dec:                         # whisper-style cross attention
        enc = b.load(b.input("enc_out", (min(cfg.enc_frames, 128), D)))
        h = _attn_block(b, h, D, cfg.hd, enc=enc)
    if cfg.ssm is None:
        h = _ffn_block(b, h, cfg)
    b.mark_output(h)
    return b.g


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

KERNEL_BENCHES = {
    "atax": atax, "gesummv": gesummv, "gemm": gemm, "mvt": mvt, "3mm": three_mm,
    "residual_mlp": residual_mlp, "autoencoder": autoencoder,
    "residual_block": residual_block, "dws_conv_block": dws_conv_block,
    "conv3_block": conv3_block, "feed_forward": feed_forward,
    "multi_head_attention": multi_head_attention,
}

# name -> the traced function each public kernel builder traces (all
# module-level: a BatchJob carrying one pickles into worker processes).
KERNEL_FNS = {
    "atax": atax_fn, "gesummv": gesummv_fn, "gemm": gemm_fn, "mvt": mvt_fn,
    "3mm": three_mm_fn, "residual_mlp": residual_mlp_fn,
    "autoencoder": autoencoder_fn, "residual_block": residual_block_fn,
    "dws_conv_block": dws_conv_block_fn, "conv3_block": conv3_block_fn,
    "feed_forward": feed_forward_fn,
    "multi_head_attention": multi_head_attention_fn,
}

DNN_BENCHES = {
    "resnet18": resnet18, "vgg16": vgg16, "mobilenet": mobilenet,
    "zfnet": zfnet, "yolo": yolo_tiny, "gpt2_block": gpt2_block,
}

# Attention / recurrence routing workloads: traced builders whose chains
# the flashattn / rglru / ssd kernel patterns claim.
RECURRENCE_BENCHES = {
    "mha_batched": mha_batched, "rglru_block": rglru_block,
    "ssd_block": ssd_block,
}


def random_inputs(graph: DataflowGraph, seed: int = 0) -> dict:
    """Fan-in-normalized random inputs/weights as float32 numpy arrays:
    deep CNN oracles stay O(1) in magnitude so fp32 comparisons remain
    meaningful.  The same arrays feed the JAX reference and the port."""
    rng = np.random.default_rng(seed)
    env = {}
    for buf in graph.buffers.values():
        if buf.kind == "input":
            env[buf.name] = rng.standard_normal(buf.shape).astype(np.float32)
        elif buf.kind == "weight":
            fan_in = int(np.prod(buf.shape[1:])) if len(buf.shape) > 1 \
                else buf.shape[0]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            env[buf.name] = (rng.standard_normal(buf.shape) * std).astype(
                np.float32)
    return env


# --------------------------------------------------------------------------
# Hand-built references.  These are the original task-by-task GB builders
# the traced functions above replaced; they are kept (not exported in
# KERNEL_BENCHES) as the ground truth the frontend is checked against:
# tests assert traced.structural_hash() == handbuilt.structural_hash() for
# every pair, i.e. tracing changes *how* graphs are written, not *what*
# the compiler sees — including the compile-cache key.
# --------------------------------------------------------------------------


def atax_handbuilt(N: int = 400, M: int = 400) -> DataflowGraph:
    b = GB("atax")
    A = b.input("A", (M, N)); x = b.input("x", (N,))
    tmp = b.mv(A, x)
    y = b.mv(A, tmp, trans=True)
    b.mark_output(y)
    return b.g


def gesummv_handbuilt(N: int = 400) -> DataflowGraph:
    b = GB("gesummv")
    A = b.input("A", (N, N)); Bm = b.input("B", (N, N)); x = b.input("x", (N,))
    t1 = b.mv(A, x)
    t2 = b.mv(Bm, x)
    y = b.vadd(t1, t2, alpha=1.5, beta=1.2)
    b.mark_output(y)
    return b.g


def gemm_handbuilt(M: int = 256, N: int = 256, K: int = 256) -> DataflowGraph:
    b = GB("gemm")
    A = b.input("A", (M, K)); Bm = b.input("B", (K, N))
    C = b.matmul(A, Bm)
    C = b.scale(C, 1.5)
    b.mark_output(C)
    return b.g


def mvt_handbuilt(N: int = 400) -> DataflowGraph:
    b = GB("mvt")
    A = b.input("A", (N, N)); y1 = b.input("y1", (N,)); y2 = b.input("y2", (N,))
    x1 = b.mv(A, y1)
    x2 = b.mv(A, y2, trans=True)
    o = b.vadd(x1, x2)
    b.mark_output(o)
    return b.g


def three_mm_handbuilt(M: int = 256) -> DataflowGraph:
    b = GB("3mm")
    A = b.input("A", (M, M)); Bm = b.input("B", (M, M))
    C = b.input("C", (M, M)); D = b.input("D", (M, M))
    E = b.matmul(A, Bm)
    Fm = b.matmul(C, D)
    G = b.matmul(E, Fm)
    b.mark_output(G)
    return b.g


def residual_mlp_handbuilt(B: int = 64, D: int = 512) -> DataflowGraph:
    b = GB("residual_mlp")
    x = b.load(b.input("x", (B, D)))
    h = b.fc(x, D, relu=True)
    h2 = b.fc(h, D)
    o = b.relu(b.add(h2, x))
    b.mark_output(o)
    return b.g


def autoencoder_handbuilt(B: int = 64, D: int = 784) -> DataflowGraph:
    b = GB("autoencoder")
    x = b.input("x", (B, D))
    h = b.fc(x, 256, relu=True)
    h = b.fc(h, 64, relu=True)
    h = b.fc(h, 256, relu=True)
    o = b.fc(h, D)
    b.mark_output(o)
    return b.g


def residual_block_handbuilt(N: int = 1, C: int = 64, H: int = 32) -> DataflowGraph:
    b = GB("residual_block")
    x = b.load(b.input("x", (N, C, H, H)))
    h = b.conv(x, C, 3, relu=True)
    h = b.conv(h, C, 3, relu=False)
    o = b.relu(b.add(h, x))          # skip: SPMC on x
    b.mark_output(o)
    return b.g


def dws_conv_block_handbuilt(N: int = 1, C: int = 64, H: int = 32) -> DataflowGraph:
    b = GB("dwsconv")
    x = b.input("x", (N, C, H, H))
    h = b.conv(x, C, 3, depthwise=True)
    o = b.conv(h, 2 * C, 1, pad=0)
    b.mark_output(o)
    return b.g


def conv3_block_handbuilt(N: int = 1, C: int = 3, H: int = 34) -> DataflowGraph:
    b = GB("conv3")
    x = b.input("x", (N, C, H, H))
    h = b.conv(x, 32, 3)
    h = b.conv(h, 32, 3)
    h = b.conv(h, 64, 3)
    b.mark_output(h)
    return b.g


def feed_forward_handbuilt(B: int = 128, D: int = 512) -> DataflowGraph:
    b = GB("feed_forward")
    x = b.input("x", (B, D))
    h = b.fc(x, 4 * D)
    h = b.gelu(h)
    o = b.fc(h, D)
    b.mark_output(o)
    return b.g


def multi_head_attention_handbuilt(S: int = 128, D: int = 256) -> DataflowGraph:
    b = GB("mha")
    x = b.input("x", (S, D))
    q = b.fc(x, D)
    k = b.fc(x, D)
    v = b.fc(x, D)
    kt = b.transpose(k)
    s = b.matmul(q, kt)
    s = b.scale(s, 1.0 / math.sqrt(D))
    p = b.softmax(s)
    att = b.matmul(p, v)
    o = b.fc(att, D)
    b.mark_output(o)
    return b.g


def resnet18_handbuilt(H: int = 32) -> DataflowGraph:
    b = GB(f"resnet18_{H}")
    x = b.input("x", (1, 3, H, H))
    if H >= 224:
        h = b.conv(x, 64, 7, stride=2, pad=3)
        h = b.maxpool(h, 2)
    else:
        h = b.conv(x, 64, 3)
    for stage, (c, blocks) in enumerate([(64, 2), (128, 2), (256, 2), (512, 2)]):
        for blk in range(blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            inp = h
            h1 = b.conv(inp, c, 3, stride=stride)
            h2 = b.conv(h1, c, 3, relu=False)
            if stride != 1 or b.shape[inp][1] != c:
                skip = b.conv(inp, c, 1, stride=stride, pad=0, relu=False)
            else:
                skip = inp
            h = b.relu(b.add(h2, skip))
    h = b.global_avgpool(h)
    o = b.fc(h, 1000)
    b.mark_output(o)
    return b.g


def gpt2_block_handbuilt(S: int = 128, D: int = 1024) -> DataflowGraph:
    b = GB("gpt2_block")
    x = b.load(b.input("x", (S, D)))
    q = b.fc(x, D)
    k = b.fc(x, D)
    v = b.fc(x, D)
    kt = b.transpose(k)
    s = b.scale(b.matmul(q, kt), 1.0 / math.sqrt(D // 16))
    p = b.softmax(s)
    att = b.matmul(p, v)
    proj = b.fc(att, D)
    h = b.add(proj, x)
    f = b.fc(h, 4 * D)
    f = b.gelu(f)
    f = b.fc(f, D)
    o = b.add(f, h)
    b.mark_output(o)
    return b.g


def vgg16_handbuilt(H: int = 32) -> DataflowGraph:
    b = GB(f"vgg16_{H}")
    x = b.input("x", (1, 3, H, H))
    h = x
    for c, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps):
            h = b.conv(h, c, 3)
        h = b.maxpool(h, 2)
    h = b.flatten(h)
    h = b.fc(h, 512, relu=True)
    h = b.fc(h, 512, relu=True)
    o = b.fc(h, 1000)
    b.mark_output(o)
    return b.g


def mobilenet_handbuilt(H: int = 32) -> DataflowGraph:
    b = GB(f"mobilenet_{H}")
    x = b.input("x", (1, 3, H, H))
    h = b.conv(x, 32, 3, stride=2 if H >= 224 else 1)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + \
           [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    for c, s in plan:
        h = b.conv(h, 0, 3, stride=s, depthwise=True)
        h = b.conv(h, c, 1, pad=0)
    h = b.global_avgpool(h)
    o = b.fc(h, 1000)
    b.mark_output(o)
    return b.g


def zfnet_handbuilt(H: int = 224) -> DataflowGraph:
    b = GB(f"zfnet_{H}")
    x = b.input("x", (1, 3, H, H))
    h = b.conv(x, 96, 7, stride=2, pad=3)
    h = b.maxpool(h, 2)
    h = b.conv(h, 256, 5, stride=2, pad=2)
    h = b.maxpool(h, 2)
    h = b.conv(h, 384, 3)
    h = b.conv(h, 384, 3)
    h = b.conv(h, 256, 3)
    h = b.maxpool(h, 2)
    h = b.flatten(h)
    h = b.fc(h, 4096, relu=True)
    h = b.fc(h, 4096, relu=True)
    o = b.fc(h, 1000)
    b.mark_output(o)
    return b.g


def yolo_tiny_handbuilt(H: int = 384, W: int = 1280) -> DataflowGraph:
    b = GB("yolo")
    x = b.input("x", (1, 3, H, W))
    h = x
    c = 16
    for _ in range(6):
        h = b.conv(h, c, 3)
        h = b.maxpool(h, 2)
        c = min(c * 2, 512)
    h = b.conv(h, 512, 3)
    h = b.conv(h, 256, 1, pad=0)
    o = b.conv(h, 255, 1, pad=0, relu=False)
    b.mark_output(o)
    return b.g


def mha_batched_handbuilt(BH: int = 4, S: int = 64, hd: int = 32) -> DataflowGraph:
    b = GB("mha_batched")
    q = b.input("q", (BH, S, hd))
    k = b.input("k", (BH, S, hd))
    v = b.input("v", (BH, S, hd))
    kt = b.transpose(k)
    s = b.scale(b.matmul(q, kt), 1.0 / math.sqrt(hd))
    p = b.softmax(s)
    o = b.matmul(p, v)
    b.mark_output(o)
    return b.g


def rglru_block_handbuilt(B: int = 2, S: int = 128, D: int = 64) -> DataflowGraph:
    b = GB("rglru_block")
    a = b.input("a", (B, S, D))
    gate = b.input("gate", (B, S, D))
    x = b.input("x", (B, S, D))
    bb = b.mul(gate, x)
    h = b.rglru_scan(a, bb)
    o = b.add(h, x)
    b.mark_output(o)
    return b.g


def ssd_block_handbuilt(nc: int = 8, BH: int = 8, P: int = 32,
                        N: int = 32) -> DataflowGraph:
    b = GB("ssd_block")
    states = b.input("states", (nc, BH, P, N))
    decay = b.input("decay", (nc, BH, 1, 1))
    prev = b.ssd_scan(states, decay)
    o = b.add(prev, states)
    b.mark_output(o)
    return b.g


# name -> (traced builder, hand-built twin); both zero-arg-callable at the
# paper's default sizes.  tests/test_frontend.py asserts hash parity.
HANDBUILT_BENCHES = {
    "atax": (atax, atax_handbuilt),
    "gesummv": (gesummv, gesummv_handbuilt),
    "gemm": (gemm, gemm_handbuilt),
    "mvt": (mvt, mvt_handbuilt),
    "3mm": (three_mm, three_mm_handbuilt),
    "residual_mlp": (residual_mlp, residual_mlp_handbuilt),
    "autoencoder": (autoencoder, autoencoder_handbuilt),
    "residual_block": (residual_block, residual_block_handbuilt),
    "dws_conv_block": (dws_conv_block, dws_conv_block_handbuilt),
    "conv3_block": (conv3_block, conv3_block_handbuilt),
    "feed_forward": (feed_forward, feed_forward_handbuilt),
    "multi_head_attention": (multi_head_attention, multi_head_attention_handbuilt),
    "resnet18": (resnet18, resnet18_handbuilt),
    "gpt2_block": (gpt2_block, gpt2_block_handbuilt),
    "vgg16": (vgg16, vgg16_handbuilt),
    "mobilenet": (mobilenet, mobilenet_handbuilt),
    "zfnet": (zfnet, zfnet_handbuilt),
    "yolo": (yolo_tiny, yolo_tiny_handbuilt),
    "mha_batched": (mha_batched, mha_batched_handbuilt),
    "rglru_block": (rglru_block, rglru_block_handbuilt),
    "ssd_block": (ssd_block, ssd_block_handbuilt),
}
