#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Every path and kernel check runs under forced routing
(``CODO_FORCE_PALLAS=1``), so every kernel launches whatever the fitted
gate decides; phase 10 asserts the default gate's plans.  Phases 4-9
call their programs with ``jit=False`` (eager), as their numbers were
always taken; phase 12 sets ``jit=True`` beside them.  In order, and
failing (non-zero exit, no result line) at the first problem:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the port from ``src/repro_torch/csrc`` (eight
   sources, one ``nvcc`` each, all started together) and prints the time
   and each kernel's name, registers and spills, and the tensor-core
   (HMMA) instructions in the SASS of the six tensor-core libraries;
3. holds each kernel against its plain PyTorch version on the card, at
   the kernel sweep's shapes and at the paths' own (flash also at hd 256
   and 1024, mmchain also at 1 to 16 rows; flash, mmchain, mmgrad,
   softmaxmm, the conv and matmul at their route shapes called twice, bit
   for bit the same, and in bfloat16), printing the max error beside its
   stated tolerance, and times kernel, plain version, bound and a library
   yardstick, and takes each kernel's profiled device time over the same
   calls; splits the tensor-core kernels' 3×TF32 error against float64
   into the split's, the order's and the accumulation's shares, cuBLAS
   or cuDNN float32 beside them (the precision phase: the chain's FFN
   product, mmgrad's, flash's with q = 0, and the conv's at the deepest
   route of each of its two tiles, the wide one also as one split of the
   whole window); shows that
   the generic ``conv2d`` body is full float32 on the card with cuDNN's
   TF32 flag at its default;
4. drives the serving path — ``codo_torch.compile(gpt2_block_fn, (S,
   1024))``, distinct seeded weights bound
   through ``params_from_numpy`` — at S=128 and S=1024: four requests
   each, the launch counters zeroed just before and read just after, then
   ``verify()`` against the task-by-task oracle on the card;
5. drives the training path — ``codo_torch.compile(gpt2_block_loss_fn,
   (S, 1024), (S, 1024), grad=True)``, distinct
   seeded parameters, input and target carried in through
   ``train_state_from_numpy`` — at S=128 and S=1024: the backward routed
   to exactly two ``streamfuse.mmgrad`` groups, four ``step()``s with the
   launch counters zeroed just before and read just after, ``verify()``
   on the card with each gradient also held to a band of its own scale,
   and (S=128) one step against the same step of the port on the CPU;
6. drives the CNN serving path — ``codo_torch.compile(resnet18_fn, (N, 3,
   224, 224))`` at N=1 and N=8 and ``vgg16_fn`` at N=1,
   fan-in-scaled seeded weights (``random_inputs``) bound through
   ``params_from_numpy`` — with the routed groups asserted (five
   ``streamfuse.conv`` chains; thirteen plus the ``streamfuse.mmchain``
   head), four requests with the launch counters zeroed just before and
   read just after (one conv kernel launch per chain a request), then
   ``verify()`` on the card and (N=1) the card against the port on the CPU;
7. drives the recurrence and attention-tail paths at published widths —
   ``rglru_block_fn`` (2, 2048, 4096), ``ssd_block_fn`` (16, 96, 64, 128),
   ``mha_batched_fn`` (16, 2048, 256) and the bare tail ``matmul(softmax(s),
   v)`` at (1024, 1024) @ (1024, 64) and (2048, 2048) @ (2048, 256) —
   through ``codo_torch.compile`` with seeded inputs
   in each model's domain: the one routed group asserted (``rglru.scan``,
   ``ssd.scan``, ``flashattn.mha``, ``streamfuse.softmaxmm``), four
   requests with the launch counters zeroed just before and read just
   after (that kernel's count and no other), ``verify()`` on the card and
   the card against the port on the CPU; then the blocked matmul through
   ``ops.mm`` at (1024, 1024) @ (1024, 4096), four calls counted the same
   way;
8. drives the slice's train paths — ``codo_torch.compile(<loss>,
   *shapes, grad=True)`` over three MSE losses
   written here: ResNet-18 at (N, 3, 224, 224) against an (N, 1000)
   target, N=1 and 8 (no group routed in any phase: cuDNN forward and
   backward, the gradient kinds' bodies in full float32); rglru_block at
   (2, 2048, 4096) with ``wrt=("a", "gate")`` and ssd_block at (16, 96,
   64, 128) with ``wrt=("states", "decay")``, the other inputs passed by
   name (exactly one ``rglru.scan`` / ``ssd.scan`` group, in the
   forward) — each with seeded inputs in its model's domain: a warm step,
   four steps with the launch counters zeroed just before and read just
   after (three scan launches a step: the forward's, and the backward's
   scan gradient's two, h and the reverse recurrence; no other kernel),
   ``verify()`` on the
   card with each gradient held to its own scale, one step against the
   port on the CPU (ResNet-18 at N=1) and one profiled step;
9. exports gpt2_block at S=128 with its weights (a ``.npz`` sidecar) and
   its train step (weights embedded) under ``build/artifacts/``, loads
   both with ``codo_torch.load`` on the card, and holds four requests
   bit for bit against the exporting program (same groups, same
   launches) and one train step from the same state within rtol 1e-6;
10. the routing fit: autotunes every path above (and gpt2_block batched
    as phase 11 serves it; each chain's routed and generic forms captured
    into CUDA graphs, as a ``jit=True`` program runs them) into a private
    ``TuningDB``, after a first run on the card of mobilenet and zfnet at
    224 x 224 and yolo_tiny at 384 x 1280 (the lowered answer against the
    oracle relative to the output's scale); prints each record (routed and
    generic walls, the choice) and ``calibrate_routing_params`` of them beside the
    ``"cuda"`` constants; asserts each path's plan under the default gate
    (``DEFAULT_GATE_PLANS``);
11. serves gpt2_block at GPT-2 medium (S=128) through
    ``repro_torch.serving.ServingRuntime`` from an exported artifact:
    flash held against its plain version at the batched shape (8, 128,
    1024); one window of eight requests as one batched dispatch (one
    compile miss, flash launched once for the batch, each answer within
    1e-4 of the request served alone, the bit-for-bit count printed);
    32 free-running requests (p50, p99) against 32 served one at a time;
    ResNet-18 per request (it cannot batch); a hot-swap to a second
    generation with requests in flight (none lost, each answer one
    generation's, later requests the new one's); a one-worker spawn pool,
    bit for bit the inline runtime's answers;
    The serving phase runs the runtime's programs eagerly (``jit=False``)
    so that its numbers compare with the earlier runs';
12. the capture phase: ``jit=True`` (the step list captured into a CUDA
    graph per input signature, ``repro_torch.core.capture``) against
    ``jit=False`` — gpt2_block at (128, 1024) and (1024, 1024): the first
    call and two replays bit for bit the eager answers, an earlier answer
    not overwritten, launches per call equal, an in-place weight change
    seen; three gpt2_block train steps at S=128 bit for bit; rglru_block's
    train step at (2, 2048, 4096) within the gradient band (capture time
    and memory printed); ResNet-18 at N=1 within ``verify``'s band; the
    serving runtime with ``jit=True`` (a window of eight bit for bit the
    eager batched program, a dispatch taken apart, free-running
    throughput, p50 and p99 beside the eager runtime's); request and step
    walls and device idle shares both ways for each;
13. the batch driver: ``codo_opt_batch`` of gpt2_block and the
    gpt2-medium arch block at seq 128 in spawned workers, the grid
    printed, each cell lowered with ``jit=True`` on the card and held
    against its oracle relative to the output's scale;
14. the sharding phase: gpt2_block at (S, 1024), S=128 and 1024, on
    ``make_debug_mesh((4, 2), ("data", "model"))`` — eight positions on
    the card, driven in lockstep from this process (the single-controller
    design of ``repro_torch.core.lowering``; one card runs the positions
    one after another, so its times are the cost of the split, not a
    scaling figure).  For ``replicate``, ``dp``, ``tp``, ``dp_tp`` and
    ``auto``: the plan and its digest, the routed and ``"sharded"``
    chains (flash routes under ``replicate`` only), one request with
    every kernel launch held against its plain version at its local
    shape, four requests with the launch counters zeroed just before and
    read just after, ``verify_sharding`` against the single-device
    program and the error relative to the output's scale, request walls
    and device times beside the single-device program's; the ring and
    ``rs_ag`` vias forced (``CODO_COLLECTIVE_*_BYTES=0``): they verify and
    are bit for bit their direct forms; the chain kernel timed at each new
    local shape; the API path (``compile(..., mesh=)``, ``verify``,
    ``lower(jit=True)`` memoized and captured bit for bit eager and within
    5e-4 of the single-device ``jit=True`` answer, export and load with
    equal digests, the loaded plan re-sharded onto the debug mesh bit for
    bit); no fallback (``mesh_from_spec`` of the 4 x 2 spec raises on one
    card, ``grad=True`` with ``mesh=`` raises ``TraceError``); and
    ``pipeline_fn`` over four stages of ``tanh(x·w + b)`` at D=1024, eight
    microbatches of 128 rows, bit for bit ``reference_serial``;
15. the LM phase: the port's LM serving stack (``repro_torch.models``,
    the ``Generator`` with its captured decode step, ``serve --arch``),
    the card line printed first.  (a) GPT-2 medium at full width and
    depth in float32: ``forward`` / ``prefill`` of a seeded (2, 32) batch
    on the card against the port on the CPU, and teacher-forced
    ``decode_step`` over all 32 positions against ``forward`` on the card,
    each within 1e-4 of the output's scale; (b) GPT-2 medium in its
    published bfloat16: ``serve --arch gpt2-medium`` with the CLI's
    defaults (4 slots, cache 128, six requests of 8 + 8 tokens), the
    captured decode step bit for bit eager ``decode_step`` over 16 steps
    (logits, next tokens, every cache leaf), the decode step's wall both
    ways with device time and idle share, a (4, 128) ``prefill`` wall and
    tokens a second; (c) every catalog arch at ``smoke()``: ``forward``
    (one scan launch a recurrent block, no other kernel) and three decode
    steps, card against CPU within 1e-4 of scale, every cache leaf too,
    and the same steps through the captured serve step (``ServeStep``)
    bit for bit the eager steps on the card;
    (d) mamba2-780m and recurrentgemma-9b at full width, one block-pattern
    group deep (1 and 3 layers), float32: each ``ssd_chunk_scan`` /
    ``rglru_scan`` launch of a (1, 512) prefill held at the model's shape
    against its plain version and timed beside its byte bound, the counted
    prefill launching one scan a recurrent block, and its logits against
    teacher-forced decode on the card within 1e-4 of scale;
16. the train phase: the port's LM training (``repro_torch.training``:
    AdamW, the captured ``TrainStep``, the CLI, checkpoints), the card
    line printed first.  (a) ``rglru_scan`` at (1, 2048, 4096) and
    ``ssd_chunk_scan`` at (8, 96, 64, 128) through their autograd
    Functions: one forward and one backward launch each, the output and
    both gradients against autograd through the plain version within
    ``TOL["f32"]`` of scale, the forward and the backward helper timed
    beside their plain forms and byte bounds; (b) mamba2-780m (one layer)
    and recurrentgemma-9b (rglru, rglru, attn) at full width in float32:
    ``loss_fn`` and every gradient of a seeded (1, 512) ``SyntheticLM``
    batch card against CPU within ``GRAD_TOL`` of each leaf's scale,
    three scan launches a recurrent block, every recurrent-branch leaf
    nonzero, one ``adamw_update`` within ``UPDATE_TOL`` in norm; (c)
    ``training.cli.main`` at mamba2-780m full width and depth (bfloat16,
    (2, 2048)) and recurrentgemma-9b three layers deep ((1, 2048)), six
    captured steps each: losses finite, the scan's launches three a block
    a step and no other kernel, the replays' walls, a step's device time
    and idle share, peak memory; (d) three ``train`` steps of mamba2-780m
    one layer deep captured and eager: parameters, m, v and losses bit
    for bit, the step's wall both ways; (e) ``--fail-at 3`` with a
    checkpoint every two steps exits 42, ``--resume`` runs steps 3-6 bit
    for bit the uninterrupted run's; (f) ``--compiled`` at (128, 1024):
    the backward's mmgrad launches of four steps, no other kernel;
17. the mesh phase: the LM stack on ``make_debug_mesh((4, 2), ("data",
    "model"))`` — eight positions on the card driven in lockstep
    (``repro_torch.distributed.spmd``), the card line printed first and
    beside every wall.  (a) mamba2-780m at full width and depth
    (bfloat16 parameters, float32 moments), global batch (8, 2048), two
    a data position, no masked boundary: the unsharded ``TrainStep`` over
    the batch in four microbatches (captured), then two captured
    ``jit_train_step`` steps from the same state: the loss within 1e-4
    relative, every gathered parameter within one bfloat16 step and m / v
    within ``UPDATE_TOL`` in norm (the leaves bit for bit counted),
    ``ssd_chunk_scan``'s launches (forward and remat, and the backward
    helper's) counted, the shards written in place with their specs'
    shapes, each position's state bytes beside its specs' share, the peak
    memory, the same two steps eagerly bit for bit, replay walls and
    device time both ways; ``ssd_chunk_scan`` at a data block's shape
    through its autograd Function; (b) recurrentgemma-9b at full width,
    three layers deep, float32: ``jit_prefill_step`` at (4, 512) against
    the unsharded prefill within 1e-4 of scale, ``rglru_scan`` launched
    once a RG-LRU block and data block and held at its shape against its
    plain version; (c) gpt2-medium bfloat16: 16 captured
    ``jit_serve_step`` steps at 8 slots and cache 1024 against the
    unsharded ``ServeStep``: the logits every step and every cache leaf
    within 2.5e-2 of scale, a control (a data block decoding on its
    neighbour's cache rows) beyond that band, a differing token only at a
    top-2 margin within one bfloat16 step of the top logit, the cache
    shards written in place; (d) the elastic restart: mamba2-780m
    one layer deep in float32, a failure on 4 x 2, ``resume(shardings=
    ...)`` onto 2 x 2, the losses and state against the uninterrupted
    run; (e) ``compressed_allreduce`` under ``shard_map`` over eight
    positions against the plain sum, within 0.02;
18. the rank phase: the 4 x 2 mesh split over ranks, one process a card
    (``repro_torch.launch.ranks.spawn``, ``launch.mesh.rank_mesh``), the
    card line printed first: (a) one NCCL rank runs mamba2-780m at full
    width and depth, two captured steps from the seeded state the mesh
    phase's (a) starts from, bit for bit the same steps eager on the rank
    and the single-process captured step run in the same process (loss,
    parameters, m and v), its all-gathers captured into the graph (at one
    rank NCCL's all-gather is a device copy, no NCCL kernel names it),
    step walls and device time beside the mesh phase's single-process
    step; (b) the same rank compiles gpt2_block at (128, 1024) on the
    rank mesh with ``jit=True``, strategies ``replicate`` and ``dp_tp``:
    ``verify()``, one graph, answers bit for bit the single-process
    program's, the chain (and, replicated, flash) launched, the
    all-gathers captured,
    request walls both ways; (c) two gloo ranks on the one card run the
    trainer eagerly, four layers deep, bit for bit the single-process
    step; (d) with two cards or more, NCCL ranks over min(count, 4) cards
    with (a) and (b), NCCL kernels in each rank's profiled replay, else
    one line saying it did not run;
19. the launch phase: the port's last entry points, the card line
    printed first.  Subprocesses run side by side (their walls printed):
    (a) ``python -m repro_torch.api`` for ``feed_forward``,
    ``multi_head_attention`` and ``conv3_block`` with ``--run`` and a fresh
    ``--cache-dir``, cold then warm: ``cache_hit=False`` then ``True``
    with one ``key=``, the numerics verified on the card both times; then
    ``api.main`` of each in this process with the launch counters zeroed
    just before and read just after (the chain, flash and conv kernels
    each launched); (b) ``pad_conv_relu(use_kernel=True)`` at ResNet-18's
    N=8 64 x 56² and VGG-16's first chain against ``use_kernel=False``
    within ``CONV_TOL`` of scale, one conv launch a call counted, event and
    device times beside cuDNN's; (c) the five ``examples/torch/*.py`` on
    the card, each exiting 0 with its verdict line; (d) the dry-run:
    ``python -m repro_torch.launch.dryrun`` of mamba2-780m ``train_4k`` on
    the (16, 16) mesh of meta positions (``status: ok``; FLOPs, bytes,
    collective bytes, wall), then the mesh phase's own configuration
    costed through ``dryrun.run_cell``: a position's parameter and
    optimizer bytes equal to the bytes the mesh phase measured a
    position, its predicted peaks beside the measured one, and its FLOPs a
    step over the measured replay wall; (e) ``python -m
    repro_torch.launch.perf`` on the cell with ``base`` and
    ``REPRO_REMAT_POLICY=dots``, both rows printed;
20. no fallback: a step that reads a device value on the host raises
    ``CaptureError`` naming the step;
21. prints the card line, the ``kernels`` JSON line (the scans' entries
    five times: their serving, their train-path, the LM prefills', the
    trainers' and the mesh phase's launches, the trainers' split into the
    forward and the backward helper; flash's also at the serving batch;
    the chain's also at the sharded phase's local shapes; the conv's also
    at the launch phase's two ``pad_conv_relu`` shapes) and, last, the
    ``{"ok": true, "device": ...}`` line.

The full record (every check, every timing) goes to
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D_MODEL = 1024                  # GPT-2 medium width
SEQS = (128, 1024)
REQUESTS = 4
TRAIN_STEPS = 4
SEED = 0
# Published peaks of one H100 SXM (data sheet): float32 outside the tensor
# cores, and device memory bandwidth: each kernel's bound.  Flash, the
# large-M mmchain form, mmgrad, softmaxmm, the conv and matmul run a
# float32 product as three TF32 products on the tensor cores (495 TFLOP/s
# of TF32, so 165 of float32-accurate work): their bound is at that rate,
# the float32 CUDA-core one kept beside it.
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# Tolerances, kernel against plain version on the card.  The kernels and
# cuBLAS sum float32 products in different orders; the sweep shapes keep
# tests/test_kernels.py's bands, the D=1024 shapes allow for K-term sums
# (K up to 4096): typical error ~sqrt(K)·u·|terms| ≈ 1e-5, bound 1e-4.
TOL = {"f32": 2e-5, "bf16": 2e-2, "f32_wide": 1e-4}
# verify() band on the card: the oracle runs each matmul through cuBLAS,
# the routed path through the two kernels, whose sums over K=1024 and
# N1=4096 run in another order — 1e-5 (the reference's CPU band) is not a
# bound for that; 1e-4 is ~sqrt(4096)·u·|h|·|w| with headroom.
VERIFY_BAND = 1e-4
# The train step's verify() band on the card: the reference's own
# (repro/api.py CompiledTrainStep.verify), loss and gradients against
# autograd through the oracle.  Its atol is about one gradient's size at
# D=1024 (the loss is a mean over S·D), so it is only the outer gate.
TRAIN_BAND = dict(rtol=2e-3, atol=1e-4)
# The inner gate, each tensor against its own scale: a gradient or
# AdamW moment within GRAD_TOL·max|reference| (v = 0.001·g², twice g's
# relative error).  The card's kernels and cuBLAS sum K up to 4096
# products in other orders than the oracle or the CPU, ~sqrt(K)·u ≈ 4e-6
# relative, and on an H100 the readings are 7e-7 to 3e-6: 1e-4 leaves
# room for the backward's chained sums and sees a wrong term.
GRAD_TOL = 1e-4
# One step's update p1 - p0, card against CPU, in norm: AdamW's first step
# moves each parameter by lr·g/(|g| + eps), so where |g| is within
# rounding of eps the two may move a parameter differently by up to lr;
# such entries are few, and in norm the difference stays small, while a
# skipped update (1) or a flipped sign (2) does not.
UPDATE_TOL = 1e-2
MMGRAD = "pallas:streamfuse.mmgrad"
PHASES = ("forward", "backward", "update")      # of a train step
# The CNN path: ImageNet's 224 x 224 input, ResNet-18 at N = 1 and 8,
# VGG-16 at N = 1.  Conv tolerances: the reference sweep's 1e-4
# (tests/test_kernels.py, rtol and atol) at its shapes and the ragged
# ones; at the route shapes 1e-4 of each output's own scale (sums of up
# to 4608 float32 products in another order than the plain version: the
# readings are ~1e-6 of the scale).
IMAGE = 224
CNN_BATCHES = (1, 8)
CONV_TOL = 1e-4
CONV = "pallas:streamfuse.conv"
MMCHAIN = "pallas:streamfuse.mmchain"
# The routed pad -> conv -> relu chains, (C, CO, H = W), K = 3: ResNet-18's
# five stride-1 chains and VGG-16's thirteen.
RESNET_ROUTES = [(64, 64, 56), (64, 64, 56), (128, 128, 28), (256, 256, 14),
                 (512, 512, 7)]
VGG_ROUTES = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
              (128, 256, 56), (256, 256, 56), (256, 256, 56), (256, 512, 28),
              (512, 512, 28), (512, 512, 28), (512, 512, 14), (512, 512, 14),
              (512, 512, 14)]
# VGG-16's fc -> relu -> fc head, routed to the chain kernel at one row.
VGG_HEAD = (1, 512 * 7 * 7, 512, 512)
RELU = (("relu", {}),)
# The generic conv2d body on the card against float64, with cuDNN's TF32
# flag at its default: full float32 reads ~1e-7 of the scale, TF32 ~1e-3.
F32_CONV_TOL = 1e-5
# The recurrence and attention-tail slice at published widths, float32:
# RecurrentGemma-9B's recurrence (d_model 4096 over its local window of
# 2048, B = 2) and attention (16 heads of 256 at S = 2048, heads folded);
# Mamba-2 780M's SSD chunk states (d_inner 3072 = 48 heads of 64, d_state
# 128, chunk 256 at S = 4096: 16 chunks, B = 2); the attention tail at one
# GPT-2-medium head and one RecurrentGemma-9B head; the blocked matmul at
# the GPT-2-medium FFN's fc, (M, K, N).
RGLRU_SHAPE = (2, 2048, 4096)
# rglru_scan's grid far past the card's resident blocks, and the calls in
# a row that must repeat bit for bit.
RGLRU_BIG = (4, 8192, 4096)
RGLRU_REPEATS = 20
SSD_SHAPE = (16, 96, 64, 128)
MHA_SHAPE = (16, 2048, 256)
TAIL_SHAPES = [(1024, 1024, 64), (2048, 2048, 256)]
MM_SHAPE = (1024, 1024, 4096)
# Bands, kernel against plain version: the reference sweep's
# (tests/test_kernels.py) — rglru 1e-4, ssd 1e-5, matmul 1e-3 in float32
# and 5e-2 in bfloat16 — and flash's for the attention tail (TOL).
RGLRU_TOL, SSD_TOL = 1e-4, 1e-5
# gpt2_block's verify() error on the card at S = 128 / 1024, pinned at
# the level of full float32 accumulation: the chain and flash promote
# each 32-deep stage of the tensor cores' accumulation (unpromoted, they
# read 4.5e-5 / 5.7e-5).
GPT2_VERIFY_PIN = {128: 1.5e-5, 1024: 3.4e-5}
# chain.cu's promotion: each stage of this many products of k into a
# fresh tensor-core accumulator (its BK).
CHAIN_STAGE = 32
MM_TOL = {"f32": 1e-3, "bf16": 5e-2}
RGLRU = "pallas:rglru.scan"
SSD = "pallas:ssd.scan"
FLASH = "pallas:flashattn.mha"
SOFTMAXMM = "pallas:streamfuse.softmaxmm"
# The routing fit: every matched chain of every path timed routed and
# generic (best-of walls, host time included) into a private TuningDB;
# the generic scans are Python loops over time, so fewer repeats there.
FIT_REPEATS = 5
FIT_SCAN_REPEATS = 3
# Catalog CNNs that first run on the card in the routing fit, at N = 1:
# ImageNet's 224 x 224 for mobilenet and zfnet, yolo_tiny's 384 x 1280.
NEW_CNNS = [("mobilenet", (1, 3, IMAGE, IMAGE)), ("zfnet", (1, 3, IMAGE, IMAGE)),
            ("yolo_tiny", (1, 3, 384, 1280))]
# The serving phase: gpt2_block at GPT-2 medium (S = 128) behind the
# runtime, one window of SERVE_BATCH requests coalesced into one batched
# dispatch, then SERVE_FREE requests free-running.
SERVE_S = 128
SERVE_BATCH = 8
SERVE_FREE = 32
# The routed groups of each path under the default gate with the fitted
# "cuda" parameters (costmodel.DEFAULT_ROUTING_PARAMS); a train step's by
# phase.  Flash and the FFN chain lost to the generic path on the card
# (both forms captured), so no gpt2_block forward or attention routes; the
# conv chains, mmgrad, the scans and the softmax tail (at parity, 1.03)
# do.  The tests pin the same plans on the CPU ("cuda" backend) for the
# gpt2, CNN and recurrence paths.
DEFAULT_GATE_PLANS: dict = {
    "gpt2_block S=128": [], "gpt2_block S=1024": [],
    f"gpt2_block serving batch {SERVE_BATCH}": [],
    **{f"gpt2_block train S={S}": {"forward": [], "backward": [MMGRAD] * 2,
                                   "update": []} for S in SEQS},
    "resnet18 N=1": [CONV] * 5, "resnet18 N=8": [CONV] * 5,
    "vgg16 N=1": [CONV] * 13, "rglru_block": [RGLRU], "ssd_block": [SSD],
    "mha_batched": [], "attention_tail 1024x1024x64": [SOFTMAXMM],
    "attention_tail 2048x2048x256": [SOFTMAXMM], "mobilenet N=1": [],
    "zfnet N=1": [CONV] * 3, "yolo_tiny N=1": [CONV] * 7}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def all_libraries() -> dict:
    """Every kernel library of the port, by the short name the record
    uses."""
    from repro_torch.kernels import flashattn, matmul, rglru, ssd, streamfuse
    return {"flash": flashattn.LIBRARY, "mmchain": streamfuse.LIBRARY,
            "mmgrad": streamfuse.GRAD_LIBRARY,
            "conv": streamfuse.CONV_LIBRARY,
            "softmaxmm": streamfuse.SOFTMAX_LIBRARY, "rglru": rglru.LIBRARY,
            "ssd": ssd.LIBRARY, "matmul": matmul.LIBRARY}


# The libraries whose kernels run mma.sync on the tensor cores.
TENSOR_CORE_LIBS = ("flash", "mmchain", "mmgrad", "softmaxmm", "conv",
                    "matmul")


def tensor_core_sass(libs: dict) -> dict:
    """The tensor-core instructions (HMMA, by form) in each built
    tensor-core library's SASS, read with cuobjdump beside nvcc; failing
    if a library has none, or if the toolkit has no cuobjdump to read
    them with."""
    from collections import Counter

    from repro_torch.kernels import common
    tool = Path(common._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        fail(f"no cuobjdump beside nvcc ({tool}): the tensor-core "
             f"instructions of the kernels cannot be read")
    out = {}
    for key in TENSOR_CORE_LIBS:
        sass = subprocess.run([str(tool), "-sass", str(libs[key].path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        ops = Counter(re.findall(r"\b(HMMA\.[\w.]+)", sass))
        out[libs[key].source.name] = dict(ops)
        print(f"SASS {libs[key].source.name}: "
              f"{', '.join(f'{k} x{v}' for k, v in sorted(ops.items()))}")
        if not ops:
            fail(f"{libs[key].source.name}: no tensor-core (HMMA) "
                 f"instruction in its SASS")
    return out


def zero_counts() -> None:
    """Every kernel library's launch counters to 0 (just before a path
    is driven)."""
    for lib in all_libraries().values():
        lib.reset_counts()


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up; operands stay L2-warm between calls)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tf32x3_bound(flops: float, nbytes: float) -> dict:
    """The bound of a kernel that runs each float32 product as three TF32
    products on the tensor cores (bound_ms, bound_by: 165 TFLOP/s), with
    the float32 CUDA-core bound beside it (bound_f32_ms, bound_f32_by)."""
    ms, by = bound_ms(flops, nbytes, PEAK_TF32X3_FLOPS)
    f32, f32_by = bound_ms(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "bound_f32_ms": f32,
            "bound_f32_by": f32_by}


def bound_text(m: dict) -> str:
    """A measurement's bound as printed: the 3×TF32 one with the float32
    one beside it, or the float32 one alone."""
    text = f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}"
    if "bound_f32_ms" in m:
        text += f", 3xTF32; float32 {m['bound_f32_ms']:.4f}"
    return text + ")"


def f32_bound(m: dict) -> dict:
    """The float32 CUDA-core bound of a measurement whose bound_ms is the
    3×TF32 one, as extra keys of its kernels-line entry; else nothing."""
    return ({k: m[k] for k in ("bound_f32_ms", "bound_f32_by")}
            if "bound_f32_ms" in m else {})


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(record: list, name: str, got, want, tol: float) -> float:
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    ok = err <= tol * (1.0 + scale)
    print(f"  {name:<48s} max_abs_err {err:.3e}  tol {tol:.0e}·(1+{scale:.2f})"
          f"  {'ok' if ok else 'FAIL'}")
    record.append({"case": name, "max_abs_err": err, "tol": tol,
                   "max_abs_ref": scale, "ok": ok})
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def same(record: list, name: str, got, again) -> None:
    """Two calls on the same operands: bit-identical outputs (the kernels
    sum in a fixed order, with no atomics)."""
    import torch
    ok = bool(torch.equal(got, again))
    record.append({"case": f"{name} twice", "bit_identical": ok, "ok": ok})
    if not ok:
        fail(f"{name}: two calls on the same operands differ")


def check_flash(record: list) -> None:
    import torch
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for B, Hq, Hkv, S, hd in [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64),
                              (1, 8, 1, 256, 128), (2, 2, 2, 384, 32)]:
        for causal, window in [(True, 0), (False, 0), (True, 128)]:
            for dtype, tol in [(torch.float32, TOL["f32"]),
                               (torch.bfloat16, TOL["bf16"])]:
                q = torch.randn(B, Hq, S, hd, generator=g, device="cuda")
                k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
                v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                kw = dict(causal=causal, window=window)
                check(record, f"flash {B}x{Hq}/{Hkv}x{S}x{hd} c={int(causal)} "
                      f"w={window} {str(dtype)[6:]}",
                      flash_attention(q, k, v, **kw),
                      flash_attention_plain(q, k, v, **kw), tol)
    q, k, v = (torch.randn(1, 3, 100, 40, generator=g, device="cuda")
               for _ in range(3))
    check(record, "flash ragged 1x3x100x40 c=1", flash_attention(q, k, v),
          flash_attention_plain(q, k, v), TOL["f32"])
    # The 256-column tiles (GQA, causal, window) and the cluster form
    # (hd > 256: 4 blocks share a q tile) at a ragged S, each called twice:
    # the two calls must agree bit for bit.
    for B, Hq, Hkv, S, hd, causal, window in [
            (1, 4, 2, 300, 256, True, 0), (1, 4, 1, 300, 256, True, 100),
            (2, 2, 2, 200, 256, False, 0), (1, 1, 1, 333, 1024, False, 0),
            (1, 2, 1, 333, 1024, True, 64)]:
        for dtype, tol in [(torch.float32, TOL["f32"] if hd <= 256
                            else TOL["f32_wide"]),
                           (torch.bfloat16, TOL["bf16"])]:
            q = torch.randn(B, Hq, S, hd, generator=g, device="cuda")
            k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
            v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(causal=causal, window=window)
            name = (f"flash {B}x{Hq}/{Hkv}x{S}x{hd} c={int(causal)} "
                    f"w={window} {str(dtype)[6:]}")
            got = flash_attention(q, k, v, **kw)
            check(record, name, got, flash_attention_plain(q, k, v, **kw), tol)
            same(record, name, got, flash_attention(q, k, v, **kw))
    # k as a kᵀ view (the routed chains hand it over so) with Sk a multiple
    # of 8 and of 4: the K tiles are copied in 16-byte vectors along the
    # keys into rows stored d by d, in both element types; each called
    # twice.
    for B, Hq, Hkv, S, hd, causal in [(1, 2, 1, 264, 256, True),
                                      (1, 1, 1, 264, 1024, False)]:
        for dtype, tol in [(torch.float32, TOL["f32"] if hd <= 256
                            else TOL["f32_wide"]),
                           (torch.bfloat16, TOL["bf16"])]:
            q = torch.randn(B, Hq, S, hd, generator=g, device="cuda")
            kt = torch.randn(B, Hkv, hd, S, generator=g, device="cuda")
            v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
            q, v = q.to(dtype), v.to(dtype)
            k = kt.to(dtype).transpose(-1, -2)
            name = (f"flash kT view {B}x{Hq}/{Hkv}x{S}x{hd} c={int(causal)} "
                    f"{str(dtype)[6:]}")
            got = flash_attention(q, k, v, causal=causal)
            check(record, name, got,
                  flash_attention_plain(q, k, v, causal=causal), tol)
            same(record, name, got, flash_attention(q, k, v, causal=causal))


def flash_route_operands(S: int, g):
    """The routed chain's operands at width D: q (S, D), kᵀ (D, S) handed
    over as a transposed view, v (S, D); single head, hd = D."""
    import torch
    q = torch.randn(S, D_MODEL, generator=g, device="cuda")
    kt = torch.randn(D_MODEL, S, generator=g, device="cuda")
    v = torch.randn(S, D_MODEL, generator=g, device="cuda")
    return q[None, None], kt.transpose(-1, -2)[None, None], v[None, None]


def chain_route_operands(S: int, g):
    import torch
    a = torch.randn(S, D_MODEL, generator=g, device="cuda")
    w1 = torch.randn(D_MODEL, 4 * D_MODEL, generator=g,
                     device="cuda") / math.sqrt(D_MODEL)
    w2 = torch.randn(4 * D_MODEL, D_MODEL, generator=g,
                     device="cuda") / math.sqrt(4 * D_MODEL)
    return a, w1, w2


GELU = (("gelu", {}),)
AFFINE_RDIVC = (("affine", {"a": 1.0, "b": 4.0}), ("rdivc", {"c": 2.0}))
C = 1.0 / math.sqrt(D_MODEL // 16)     # gpt2_block's score scale


def check_chain(record: list) -> None:
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                matmul_chain_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for S in SEQS:
        a, w1, w2 = chain_route_operands(S, g)
        for tail_name, ew in [("gelu", GELU),
                              ("relu+scale", (("relu", {}),
                                              ("scale", {"s": 0.5})))]:
            name = f"mmchain {S}x{D_MODEL}x{4 * D_MODEL}x{D_MODEL} {tail_name}"
            got = fused_matmul_chain(a, w1, w2, ew=ew)
            check(record, name, got, matmul_chain_plain(a, w1, w2, ew=ew),
                  TOL["f32_wide"])
            same(record, name, got, fused_matmul_chain(a, w1, w2, ew=ew))
    a, w1, w2 = (torch.randn(*s, generator=g, device="cuda") * 0.3
                 for s in [(100, 96), (96, 200), (200, 72)])
    ew = AFFINE_RDIVC
    check(record, "mmchain ragged 100x96x200x72 affine+rdivc",
          fused_matmul_chain(a, w1, w2, ew=ew),
          matmul_chain_plain(a, w1, w2, ew=ew), TOL["f32"])
    a, w1, w2 = ((torch.randn(*s, generator=g, device="cuda") * 0.1).bfloat16()
                 for s in [(128, 256), (256, 512), (512, 128)])
    check(record, "mmchain 128x256x512x128 gelu bf16",
          fused_matmul_chain(a, w1, w2, ew=GELU),
          matmul_chain_plain(a, w1, w2, ew=GELU), TOL["bf16"])
    # The small-M form (a K-split GEMV) at ragged K / N1 / N2, weights over
    # the root of their depth, each called twice: bit for bit the same.
    for M, K, N1, N2, dtype, tol, tail in [
            (1, 999, 200, 72, torch.float32, TOL["f32"], AFFINE_RDIVC),
            (3, 999, 200, 72, torch.float32, TOL["f32"], AFFINE_RDIVC),
            (16, 1001, 130, 70, torch.float32, TOL["f32"], AFFINE_RDIVC),
            (1, 1024, 512, 256, torch.bfloat16, TOL["bf16"], GELU)]:
        a = torch.randn(M, K, generator=g, device="cuda")
        w1 = torch.randn(K, N1, generator=g, device="cuda") / math.sqrt(K)
        w2 = torch.randn(N1, N2, generator=g, device="cuda") / math.sqrt(N1)
        a, w1, w2 = a.to(dtype), w1.to(dtype), w2.to(dtype)
        name = f"mmchain rows {M}x{K}x{N1}x{N2} {str(dtype)[6:]}"
        got = fused_matmul_chain(a, w1, w2, ew=tail)
        check(record, name, got, matmul_chain_plain(a, w1, w2, ew=tail), tol)
        same(record, name, got, fused_matmul_chain(a, w1, w2, ew=tail))


GELU_GRAD = (("gelu_grad", {}, 0),)
SOFTMAX_GRAD = (("softmax_grad", {"axis": -1}, 0), ("scale", {"s": C}, None))


def grad_route_operands(S: int, g) -> dict:
    """The two routed backward chains' operands at width D, as the train
    step hands them over: the FFN's cotangent (S, D) @ W_fc2ᵀ with the
    gelu input (S, 4D), and the attention's (S, D) @ vᵀ with the softmax
    output (S, S); W_fc2ᵀ and vᵀ are transposed views."""
    import torch
    a = torch.randn(S, D_MODEL, generator=g, device="cuda")
    w_fc2 = torch.randn(4 * D_MODEL, D_MODEL, generator=g,
                        device="cuda") / math.sqrt(4 * D_MODEL)
    fc = torch.randn(S, 4 * D_MODEL, generator=g, device="cuda")
    v = torch.randn(S, D_MODEL, generator=g, device="cuda")
    sm = torch.softmax(torch.randn(S, S, generator=g, device="cuda"), -1)
    return {"ffn": (a, w_fc2.t(), fc, GELU_GRAD),
            "attn": (a, v.t(), sm, SOFTMAX_GRAD)}


def check_grad(record: list) -> None:
    """fused_matmul_grad against matmul_grad_plain: each tail kind, ragged
    M/N/K, transposed w, a transposed a with an expand-view extra, float32
    and bfloat16, and the route's own shapes."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_grad,
                                                matmul_grad_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    tails = {"relu_grad": ((("relu_grad", {}, 0),), "x"),
             "gelu_grad+affine": ((("gelu_grad", {}, 0),
                                   ("affine", {"a": -1.0, "b": 0.5}, None)),
                                  "x"),
             "softmax_grad+scale": (SOFTMAX_GRAD, "y"),
             "divc+softmax_grad+affine+rdivc+relu_grad": (
                 (("divc", {"c": 3.0}, None),
                  ("softmax_grad", {"axis": -1}, 0),
                  ("affine", {"a": 1.0, "b": 4.0}, None),
                  ("rdivc", {"c": 2.0}, None), ("relu_grad", {}, 1)), "yx"),
             "softmax_grad x2+gelu": ((("softmax_grad", {}, 0),
                                       ("softmax_grad", {}, 0),
                                       ("gelu", {}, None)), "y")}
    for M, K, N in [(100, 96, 200), (37, 50, 130), (128, 1024, 64)]:
        for w_t in (False, True):
            a = rn(M, K) * 0.3
            w = (rn(N, K).t() if w_t else rn(K, N)) * 0.3
            x = rn(M, N)
            ex = {"x": x, "y": torch.softmax(x, -1)}
            for name, (ew, kinds) in tails.items():
                extras = [ex[k] for k in kinds]
                check(record, f"mmgrad {M}x{K}x{N}{' wT' if w_t else ''} "
                      f"{name}", fused_matmul_grad(a, w, *extras, ew=ew),
                      matmul_grad_plain(a, w, *extras, ew=ew), TOL["f32"])
    a, w, e = rn(96, 100).t(), rn(96, 72), rn(1, 72).expand(100, 72)
    ew = (("relu_grad", {}, 0), ("scale", {"s": 2.0}, None))
    check(record, "mmgrad aT 100x96x72 expand extra relu_grad",
          fused_matmul_grad(a, w, e, ew=ew),
          matmul_grad_plain(a, w, e, ew=ew), TOL["f32"])
    for name, (ew, kinds) in [("gelu_grad", (GELU_GRAD, "x")),
                              ("softmax_grad+scale", (SOFTMAX_GRAD, "y"))]:
        a = (rn(128, 256) * 0.3).bfloat16()
        w = (rn(512, 256) * 0.3).bfloat16().t()
        x = rn(128, 512)
        e = (torch.softmax(x, -1) if kinds == "y" else x).bfloat16()
        check(record, f"mmgrad 128x256x512 wT {name} bf16",
              fused_matmul_grad(a, w, e, ew=ew),
              matmul_grad_plain(a, w, e, ew=ew), TOL["bf16"])
    # bfloat16 with an N-contiguous w (its tile kept by k).
    a, w = (rn(128, 256) * 0.3).bfloat16(), (rn(256, 512) * 0.3).bfloat16()
    e = rn(128, 512).bfloat16()
    check(record, "mmgrad 128x256x512 gelu_grad bf16",
          fused_matmul_grad(a, w, e, ew=GELU_GRAD),
          matmul_grad_plain(a, w, e, ew=GELU_GRAD), TOL["bf16"])
    # The route's shapes, each called twice (bit for bit the same); and
    # the FFN chain in bfloat16.
    for S in SEQS:
        for chain, (a, w, e, ew) in grad_route_operands(S, g).items():
            name = f"mmgrad route {chain} {S}x{D_MODEL}x{w.shape[1]}"
            got = fused_matmul_grad(a, w, e, ew=ew)
            want = matmul_grad_plain(a, w, e, ew=ew)
            check(record, name, got, want, TOL["f32_wide"])
            same(record, name, got, fused_matmul_grad(a, w, e, ew=ew))
    a, w, e, ew = grad_route_operands(SEQS[0], g)["ffn"]
    a, w, e = a.bfloat16(), w.bfloat16(), e.bfloat16()
    name = f"mmgrad route ffn {SEQS[0]}x{D_MODEL}x{w.shape[1]} bf16"
    got = fused_matmul_grad(a, w, e, ew=ew)
    check(record, name, got, matmul_grad_plain(a, w, e, ew=ew), TOL["bf16"])
    same(record, name, got, fused_matmul_grad(a, w, e, ew=ew))


def _tf32_parts(x):
    """hi = x rounded to TF32 as the kernels round it (mma_tf32.cuh
    to_tf32: add 0x1000, keep the top 19 bits), and lo = x - hi as the
    tensor cores read it (truncated to its top 19 bits)."""
    import torch
    keep = -8192                       # 0xffffe000 as an int32
    hi = ((x.view(torch.int32) + 0x1000) & keep).view(x.dtype)
    lo = ((x - hi).view(torch.int32) & keep).view(x.dtype)
    return hi, lo


def _rn_in_kernel_order(a_hi, a_lo, w_hi, w_lo, per: int = 0,
                        stage: int = 0):
    """The three TF32 products summed in float32 with round-to-nearest in
    the kernels' k order: 8-deep steps, three products a step, the small
    terms first, each step's 8-term dot exact and rounded once into the
    accumulator (one mma).  per > 0: each per-deep split of k into an
    accumulator of its own, the splits then summed in order.  stage > 0:
    within a split, each stage-deep stretch into a fresh accumulator added
    into the running one (a promoted kernel's order)."""
    import torch
    K = a_hi.shape[1]
    total = None
    for k0 in range(0, K, per or K):
        acc = torch.zeros(a_hi.shape[0], w_hi.shape[1], dtype=torch.float32,
                          device=a_hi.device)
        run = torch.zeros_like(acc) if stage else None
        for k in range(k0, min(K, k0 + (per or K)), 8):
            for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
                p = x[:, k:k + 8].double() @ y[k:k + 8].double()
                acc = (acc.double() + p).float()
            if stage and (k - k0 + 8) % stage == 0:
                run, acc = run + acc, torch.zeros_like(acc)
        acc = acc if run is None else run + acc
        total = acc if total is None else total + acc
    return total


def check_precision(record: dict) -> None:
    """Where the 3×TF32 tensor-core error comes from, on the card: for
    gpt2_block's FFN first product (a (1024, 1024) @ W_fc (1024, 4096),
    seeded as chain_route_operands) and the mmgrad FFN product ((1024,
    1024) @ W_fc2ᵀ), each against the exact float64 product, (2) the
    split's share: hi·hi + hi·lo + lo·hi in float64; (3) the order's: the
    same terms summed in float32 with round-to-nearest in the kernel's k
    order, against (2) — for chain.cu, which promotes each 32-deep stage,
    in that staged order, the unstaged order beside it
    (``order_unstaged``, and the kernel against it,
    ``accumulation_vs_unstaged_order``); (4) the accumulation's: the
    kernel's own output against (3); and (5) cuBLAS float32 (allow_tf32
    False) against the exact product, the scale.

    (4) for the mmgrad product is fused_matmul_grad with no tail (the
    mma_gemm.cuh tile).  For the FFN first product it is chain.cu's own a
    @ w1, read through fused_matmul_chain with no tail and w2 = I (4096 ×
    4096): the product with I adds the exact zeros and one h·1 a column,
    so it only rounds h to hi + lo as the split reads it, at most 2⁻²¹ of
    |h| (``identity_pass``, beside it).  The mma_gemm tile on the same
    operands stands beside it (``accumulation_mma_gemm``)."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                fused_matmul_grad)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    a1, w1, _ = chain_route_operands(D_MODEL, g)
    a2, w2, _, _ = grad_route_operands(D_MODEL, g)["ffn"]
    eye = torch.eye(w1.shape[1], device="cuda")
    out = {"cublas_allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    def err(x, y):
        return float((x.double() - y.double()).abs().max())

    for name, a, w in [("mmchain_ffn_fc", a1, w1), ("mmgrad_ffn", a2, w2)]:
        exact = a.double() @ w.double()
        (a_hi, a_lo), (w_hi, w_lo) = _tf32_parts(a), _tf32_parts(w)
        split = ((a_lo.double() @ w_hi.double())
                 + (a_hi.double() @ w_lo.double())
                 + (a_hi.double() @ w_hi.double()))
        unstaged = _rn_in_kernel_order(a_hi, a_lo, w_hi, w_lo)
        tile = fused_matmul_grad(a, w, ew=())
        chain = name == "mmchain_ffn_fc"
        kernel = fused_matmul_chain(a, w, eye, ew=()) if chain else tile
        order = (_rn_in_kernel_order(a_hi, a_lo, w_hi, w_lo,
                                     stage=CHAIN_STAGE)
                 if chain else unstaged)
        m = {"shape": [a.shape[0], a.shape[1], w.shape[1]],
             "kernel": "chain.cu" if chain else "mma_gemm.cuh",
             "scale": float(exact.abs().max()),
             "split": err(split, exact), "order": err(order, split),
             "accumulation": err(kernel, order),
             "cublas_f32": err(a @ w, exact),
             "kernel_vs_exact": err(kernel, exact)}
        if chain:
            m.update(promoted_stage=CHAIN_STAGE,
                     order_unstaged=err(unstaged, split),
                     accumulation_vs_unstaged_order=err(kernel, unstaged),
                     identity_pass=m["scale"] * 2.0 ** -21,
                     accumulation_mma_gemm=err(tile, unstaged))
        out[name] = m
        print(f"  precision {name} {'x'.join(map(str, m['shape']))} (output "
              f"scale {m['scale']:.3f}, kernel {m['kernel']}), max abs "
              f"error:")
        print(f"    split (hi·hi + hi·lo + lo·hi, float64) vs exact: "
              f"{m['split']:.3e}")
        print(f"    order (float32 round-to-nearest, kernel order"
              f"{', 32-deep stages' if chain else ''}) vs split: "
              f"{m['order']:.3e}")
        print(f"    accumulation (the kernel's tensor cores) vs order: "
              f"{m['accumulation']:.3e}")
        print(f"    cuBLAS float32 vs exact: {m['cublas_f32']:.3e}")
        print(f"    kernel vs exact: {m['kernel_vs_exact']:.3e}")
        if chain:
            print(f"    unstaged order vs split {m['order_unstaged']:.3e}; "
                  f"the kernel vs the unstaged order "
                  f"{m['accumulation_vs_unstaged_order']:.3e}")
            print(f"    (the product with I rounds at most "
                  f"{m['identity_pass']:.3e}; mma_gemm.cuh's tile on these "
                  f"operands: accumulation against the unstaged order "
                  f"{m['accumulation_mma_gemm']:.3e})")
    out["flash_q0"] = _flash_precision(g, err)
    out["flash_route"] = _flash_route_precision(g, err)
    out["conv"] = _conv_precision(g, err)
    record["precision"] = out


def _flash_precision(g, err) -> dict:
    """flash_attention's own tensor-core accumulation at gpt2_block's route
    (one head, hd 1024, S = 1024): with q = 0 every score is 0, P is
    exactly 1 and l exactly S, so the output is the mean of v summed on the
    tensor cores in flash's key order (64-key tiles of 8-deep steps, each
    key split apart, the splits combined in order).  Shares as the
    chain's, on the output: the split (v's hi + lo in float64), the order
    (float32 round-to-nearest in that order) and the accumulation (the
    kernel's output against the order)."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.flashattn.flashattn import key_splits
    S = SEQS[1]
    q, k, v = flash_route_operands(S, g)
    q = torch.zeros_like(q)
    got = flash_attention(q, k, v, causal=False, window=0, scale=C)[0, 0]
    v2 = v[0, 0]
    splits, tiles = key_splits(S, S, 1, D_MODEL)
    exact = v2.double().mean(0, keepdim=True)
    v_hi, v_lo = _tf32_parts(v2)
    ones = torch.ones(1, S, device="cuda")
    split = (v_hi.double() + v_lo.double()).mean(0, keepdim=True)
    order = _rn_in_kernel_order(ones, torch.zeros_like(ones), v_hi, v_lo,
                                per=64 * tiles) * (1.0 / S)
    m = {"shape": [S, S, D_MODEL], "kernel": "flashattn.cu",
         "key_splits": splits, "keys_per_split": 64 * tiles,
         "scale": float(exact.abs().max()), "split": err(split, exact),
         "order": err(order, split), "accumulation": err(got, order),
         "kernel_vs_exact": err(got, exact)}
    print(f"  precision flash q=0 {S}x{S}x{D_MODEL} (output = mean of v, "
          f"scale {m['scale']:.4f}; {splits} key splits of {64 * tiles}), "
          f"max abs error:")
    print(f"    split {m['split']:.3e}, order {m['order']:.3e}, accumulation "
          f"(flash's tensor cores) {m['accumulation']:.3e}, kernel vs exact "
          f"{m['kernel_vs_exact']:.3e}")
    return m


def _flash_route_precision(g, err) -> dict:
    """flash_attention at gpt2_block's routes (one head, hd 1024, scale
    C) against float64 attention, SDPA in float32 beside it: the error
    that its QKᵀ accumulation (each 32-deep stage promoted) leaves in the
    output, which the q = 0 reading does not see."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention
    out = {}
    for S in SEQS:
        q, k, v = flash_route_operands(S, g)
        got = flash_attention(q, k, v, causal=False, window=0, scale=C)
        exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) * C,
                              -1) @ v.double()
        sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                scale=C)
        m = {"scale": float(exact.abs().max()),
             "kernel_vs_exact": err(got, exact),
             "sdpa_f32_vs_exact": err(sdpa, exact)}
        out[str(S)] = m
        print(f"  precision flash route S={S} hd={D_MODEL}: kernel vs "
              f"float64 {m['kernel_vs_exact']:.3e}, SDPA float32 "
              f"{m['sdpa_f32_vs_exact']:.3e} (scale {m['scale']:.3f})")
    return out


def _conv_precision(g, err) -> dict:
    """fused_pad_conv_relu's own accumulation at the deepest route of each
    of its tiles, as a GEMM of w (CO, C·9) and the unfolded window (C·9,
    N·H·W), on ReLU'd outputs (the ReLU maps each error to at most
    itself): the split and order shares as above (the order split as the
    call splits the window), the kernel's accumulation against the order,
    cuDNN float32 beside them.  The wide tile (the tensor cores
    accumulating each split) at VGG-16's 512 -> 512 x 28², and again
    launched as one split of the whole 4608-deep window, the depth its
    plan never takes (CONV_WIDE_DEPTH); the narrow tile (each stage
    promoted) at ResNet-18's 64 -> 64 x 56² at N = 8, one split 576
    deep."""
    out = {}
    for key, (N, C_, CO, H) in [("vgg16_512x28", (1, 512, 512, 28)),
                                ("resnet18_n8_64x56", (8, 64, 64, 56))]:
        out[key] = _conv_shares(g, err, N, C_, CO, H)
    return out


def _conv_shares(g, err, N, C_, CO, H) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.ops import full_f32_convolutions
    from repro_torch.kernels.common import dtype_code, stream_of
    from repro_torch.kernels.streamfuse import (CONV_LIBRARY,
                                                fused_pad_conv_relu)
    from repro_torch.kernels.streamfuse.streamfuse import (conv_splits,
                                                           conv_tile_rows)
    x, w = conv_operands(N, C_, H, H, CO, 3, g)
    a = w.reshape(CO, -1)
    win = F.unfold(x, 3, padding=1).permute(1, 0, 2).reshape(C_ * 9, -1)
    splits, per = conv_splits(tuple(x.shape), tuple(w.shape))
    rows = conv_tile_rows(CO)

    def nchw(y):            # (N, CO, H, W) -> (CO, N·H·W), the GEMM's order
        return y.reshape(N, CO, -1).permute(1, 0, 2).reshape(CO, -1)

    exact = torch.relu(a.double() @ win.double())
    (a_hi, a_lo), (w_hi, w_lo) = _tf32_parts(a), _tf32_parts(win)
    split = torch.relu((a_lo.double() @ w_hi.double())
                       + (a_hi.double() @ w_lo.double())
                       + (a_hi.double() @ w_hi.double()))
    order = torch.relu(_rn_in_kernel_order(a_hi, a_lo, w_hi, w_lo, per=per))
    with full_f32_convolutions():
        cudnn = nchw(torch.relu(F.conv2d(x, w, padding=1)))
    got = nchw(fused_pad_conv_relu(x, w))
    m = {"shape": [CO, C_ * 9, N * H * H], "N": N, "kernel": "pad_conv_relu.cu",
         "tile_rows": rows, "promoted": rows == 64, "splits": splits,
         "per": per, "scale": float(exact.abs().max()),
         "split": err(split, exact), "order": err(order, split),
         "accumulation": err(got, order), "kernel_vs_exact": err(got, exact),
         "cudnn_f32": err(cudnn, exact)}
    m["kernel_vs_exact_rel"] = m["kernel_vs_exact"] / m["scale"]
    print(f"  precision conv N={N} {C_}x{H}x{H}->{CO} as "
          f"{'x'.join(map(str, m['shape']))} ({rows}-channel tile, "
          f"{'each stage promoted' if m['promoted'] else 'tensor cores alone'}"
          f"; {splits} splits of {per}; output scale {m['scale']:.3f}), max "
          f"abs error:")
    print(f"    split {m['split']:.3e}, order {m['order']:.3e}, accumulation "
          f"{m['accumulation']:.3e}; kernel vs exact "
          f"{m['kernel_vs_exact']:.3e} ({m['kernel_vs_exact_rel']:.2e} of "
          f"scale); cuDNN float32 {m['cudnn_f32']:.3e}")
    if splits > 1 and rows == 128:
        # The whole window as one split: the wide tile's error at a depth
        # its plan does not take.
        depth = C_ * 9
        one = torch.empty((N, CO, H, H), dtype=x.dtype, device=x.device)
        CONV_LIBRARY.launch("codo_pad_conv_relu", dtype_code(x), x.data_ptr(),
                            w.data_ptr(), one.data_ptr(), N, C_, H, H, CO, 3,
                            rows, depth, 1, 1, stream_of(x))
        one = nchw(one)
        order1 = torch.relu(_rn_in_kernel_order(a_hi, a_lo, w_hi, w_lo))
        m.update({"one_split_order": err(order1, split),
                  "one_split_accumulation": err(one, order1),
                  "one_split_kernel_vs_exact": err(one, exact)})
        m["one_split_kernel_vs_exact_rel"] = (m["one_split_kernel_vs_exact"]
                                              / m["scale"])
        print(f"    one split of {depth}: order {m['one_split_order']:.3e}, "
              f"accumulation {m['one_split_accumulation']:.3e}; kernel vs "
              f"exact {m['one_split_kernel_vs_exact']:.3e} "
              f"({m['one_split_kernel_vs_exact_rel']:.2e} of scale)")
    return m


def conv_operands(N, C, H, W, CO, K, g, dtype=None):
    """x (N, C, H, W) and w (CO, C, K, K) on the card, w over the square
    root of its fan-in (outputs O(1))."""
    import torch
    x = torch.randn(N, C, H, W, generator=g, device="cuda")
    w = torch.randn(CO, C, K, K, generator=g, device="cuda") / math.sqrt(
        C * K * K)
    return (x, w) if dtype is None else (x.to(dtype), w.to(dtype))


def check_scaled(record: list, name: str, got, want, tol: float) -> float:
    """Max error over the reference's own scale, failing past ``tol``."""
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    err, scale = max_err(got, want), float(want.float().abs().max())
    rel = scaled(name, err, scale, tol)
    print(f"  {name:<48s} max_abs_err {err:.3e} = {rel:.2e} of scale "
          f"{scale:.2f}  tol {tol:.0e}  ok")
    record.append({"case": name, "max_abs_err": err, "max_abs_ref": scale,
                   "rel_err": rel, "tol": tol, "ok": True})
    return err


def check_conv(record: list) -> None:
    """fused_pad_conv_relu against pad_conv_relu_plain: the reference
    sweep's shapes in float32 and bfloat16, ragged shapes (K = 5 and 7 also
    in bfloat16), ResNet-18's route shapes at N = 1 and 8 and VGG-16's at
    N = 1, each called twice (bit for bit the same) and in bfloat16; and
    VGG-16's one-row mmchain head."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                fused_pad_conv_relu,
                                                matmul_chain_plain,
                                                pad_conv_relu_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    sweep = [(1, 3, 16, 16, 8, 3), (2, 4, 8, 12, 4, 5), (1, 8, 24, 24, 16, 3)]
    ragged = [(1, 3, 9, 7, 5, 7), (2, 3, 5, 13, 6, 5), (2, 5, 17, 30, 70, 3),
              (3, 3, 31, 29, 9, 5)]
    for shape in sweep + ragged:
        both = shape in sweep or shape[-1] in (5, 7)
        for dtype, tol in ([(torch.float32, CONV_TOL),
                            (torch.bfloat16, TOL["bf16"])]
                           if both else [(torch.float32, CONV_TOL)]):
            x, w = conv_operands(*shape, g, dtype)
            check(record, f"conv {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]}", fused_pad_conv_relu(x, w),
                  pad_conv_relu_plain(x, w), tol)
    for N, routes, model in [(1, RESNET_ROUTES, "resnet18"),
                             (8, RESNET_ROUTES, "resnet18"),
                             (1, VGG_ROUTES, "vgg16")]:
        for C, CO, H in sorted(set(routes)):
            x, w = conv_operands(N, C, H, H, CO, 3, g)
            name = f"conv route {model} {N}x{C}x{H}x{H}->{CO}"
            got = fused_pad_conv_relu(x, w)
            check_scaled(record, name, got, pad_conv_relu_plain(x, w),
                         CONV_TOL)
            same(record, name, got, fused_pad_conv_relu(x, w))
            x, w = x.bfloat16(), w.bfloat16()
            check(record, f"{name} bf16", fused_pad_conv_relu(x, w),
                  pad_conv_relu_plain(x, w), TOL["bf16"])
    M, K, N1, N2 = VGG_HEAD
    a = torch.randn(M, K, generator=g, device="cuda")
    w1 = torch.randn(K, N1, generator=g, device="cuda") / math.sqrt(K)
    w2 = torch.randn(N1, N2, generator=g, device="cuda") / math.sqrt(N1)
    check_scaled(record, f"mmchain vgg16 head {M}x{K}x{N1}x{N2} relu",
                 fused_matmul_chain(a, w1, w2, ew=RELU),
                 matmul_chain_plain(a, w1, w2, ew=RELU), TOL["f32_wide"])


def check_conv_precision(record: dict) -> None:
    """The generic conv2d body on the card, with cuDNN's TF32 flag left at
    its default, against float64 on the card: full float32.  A plain
    F.conv2d under the same flag is read beside it."""
    import torch
    from repro_torch.core.ops import OpSpec, op_impl
    flag = torch.backends.cudnn.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x, w = conv_operands(1, 256, 16, 16, 256, 3, g)
    spec = OpSpec("conv2d", ("x", "w"), ("y",), {"stride": 1, "groups": 1})
    body = op_impl("conv2d")(spec, {"x": x, "w": w})["y"]
    exact = torch.nn.functional.conv2d(x.double(), w.double())
    plain = torch.nn.functional.conv2d(x, w)
    scale = float(exact.abs().max())
    body_rel = max_err(body, exact) / scale
    plain_rel = max_err(plain, exact) / scale
    print(f"  conv2d body, cudnn.allow_tf32={flag}: {body_rel:.2e} of scale "
          f"against float64 (band {F32_CONV_TOL:.0e}); F.conv2d under the "
          f"same flag {plain_rel:.2e}")
    record["conv2d_precision"] = {"cudnn_allow_tf32": flag,
                                  "body_rel_err": body_rel,
                                  "plain_conv2d_rel_err": plain_rel,
                                  "tol": F32_CONV_TOL}
    if not body_rel <= F32_CONV_TOL:
        fail(f"the conv2d body is not full float32 on the card "
             f"({body_rel:.2e} of scale, band {F32_CONV_TOL:.0e})")


def measure_conv(N: int, routes, record: dict) -> dict:
    """The conv kernel at one request's route shapes: kernel, plain and
    cuDNN (full float32) times, profiled device time, the bounds (3×TF32,
    float32 beside it) and max error; each summed over the request's chains (a
    shape that repeats is timed once and counted each time).  At N = 1,
    where a call is host-bound, an in-turns host A/B of the kept launch
    plan against the plan searched each call."""
    import torch
    from repro_torch.core.ops import full_f32_convolutions
    from repro_torch.kernels.streamfuse import (fused_pad_conv_relu,
                                                pad_conv_relu_plain)
    from repro_torch.kernels.streamfuse.streamfuse import (conv_splits,
                                                           conv_tile_rows)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6 + N)
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "flops", "bytes")
    total = dict.fromkeys(keys, 0.0)
    total["max_abs_err"], shapes = 0.0, []
    for C, CO, H in sorted(set(routes), key=routes.index):
        count = routes.count((C, CO, H))
        x, w = conv_operands(N, C, H, H, CO, 3, g)
        err = max_err(fused_pad_conv_relu(x, w), pad_conv_relu_plain(x, w))
        iters = 20 if N * H * H * C * CO <= 8 * 56 * 56 * 64 * 64 else 5

        def library():
            with full_f32_convolutions():
                return torch.relu(torch.nn.functional.conv2d(x, w, padding=1))

        ms, plain = in_turns(lambda: pad_conv_relu_plain(x, w),
                             lambda: fused_pad_conv_relu(x, w), iters)
        m = {"ms": ms, "plain_ms": plain, "library_ms": time_ms(library, iters),
             "device_ms": device_ms(lambda: fused_pad_conv_relu(x, w), iters),
             "tile_rows": conv_tile_rows(CO),
             "splits": conv_splits(tuple(x.shape), tuple(w.shape)),
             "flops": 2.0 * N * H * H * CO * C * 9,
             "bytes": 4.0 * (N * C * H * H + CO * C * 9 + N * CO * H * H)}
        m.update(tf32x3_bound(m["flops"], m["bytes"]))
        shapes.append({"N": N, "C": C, "CO": CO, "H": H, "count": count,
                       "max_abs_err": err, **m})
        for k in keys:
            total[k] += count * m[k]
        total["max_abs_err"] = max(total["max_abs_err"], err)
        print(f"  N={N} conv {C}x{H}x{H}->{CO} (x{count}, {m['tile_rows']}-"
              f"channel tile, {m['splits'][0]} splits of {m['splits'][1]}): "
              f"kernel {ms:.4f} ms (device {m['device_ms']:.4f})  plain "
              f"{plain:.4f}  cuDNN {m['library_ms']:.4f}  {bound_text(m)}")
    total.update(tf32x3_bound(total["flops"], total["bytes"]))
    total["shapes"] = shapes
    if N == 1:
        C, CO, H = routes[-1]
        x, w = conv_operands(N, C, H, H, CO, 3, g)

        def plan_each_call():
            conv_splits.cache_clear()
            return fused_pad_conv_relu(x, w)

        kept, searched = in_turns(plan_each_call,
                                  lambda: fused_pad_conv_relu(x, w), 50)
        total["host_ab"] = {"shape": [C, CO, H], "kept_plan_ms": kept,
                            "plan_each_call_ms": searched}
        print(f"  N=1 conv {C}x{H}x{H}->{CO} host A/B: kept plan {kept:.4f} "
              f"ms, plan searched each call {searched:.4f} ms a call")
    print(f"  N={N} request's conv chains: kernel {total['ms']:.4f} ms (device"
          f" {total['device_ms']:.4f})  cuDNN {total['library_ms']:.4f}  "
          f"{bound_text(total)}")
    return total


def measure_head(record: dict) -> dict:
    """The chain kernel at VGG-16's one-row fc -> relu -> fc head."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                matmul_chain_plain)
    from repro_torch.kernels.streamfuse import chain
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    M, K, N1, N2 = VGG_HEAD
    a = torch.randn(M, K, generator=g, device="cuda")
    w1 = torch.randn(K, N1, generator=g, device="cuda") / math.sqrt(K)
    w2 = torch.randn(N1, N2, generator=g, device="cuda") / math.sqrt(N1)
    tail = chain.ChainTail(RELU)        # built once, as the route does

    def kernel():
        return fused_matmul_chain(a, w1, w2, ew=tail)

    err = max_err(kernel(), matmul_chain_plain(a, w1, w2, ew=RELU))
    ms, plain = in_turns(lambda: matmul_chain_plain(a, w1, w2, ew=RELU),
                         kernel, 10)
    library = time_ms(lambda: torch.relu(a @ w1) @ w2, 10)
    # The call is host-bound, so its time is the wrapper's host work.  Each
    # host-side saving against the same calls without it, in turns: the
    # tail's codes built each call, the shape plan derived each call; and
    # what the public torch.cuda.current_stream costs against torch's
    # private raw read of the stream.
    host_ab = {}

    def plan_each_call():
        chain._chain_plan.cache_clear()
        return kernel()

    def raw_stream(t):
        return torch._C._cuda_getCurrentRawStream(t.device.index)

    for name, other, patch in [
            ("tail_each_call", lambda: fused_matmul_chain(a, w1, w2, ew=RELU),
             None),
            ("plan_each_call", plan_each_call, None),
            ("raw_stream_read", kernel, ("stream_of", raw_stream))]:
        def patched(patch=patch, other=other):
            if patch is None:
                return other()
            kept = getattr(chain, patch[0])
            setattr(chain, patch[0], patch[1])
            try:
                return other()
            finally:
                setattr(chain, patch[0], kept)
        shipped, without = in_turns(patched, kernel, 50)
        host_ab[name] = {"shipped_ms": shipped, "other_ms": without}
        print(f"  vgg16 head host A/B, {name}: shipped {shipped:.4f} ms, "
              f"other {without:.4f} ms a call")
    # The small-M form runs plain float32 FMAs: the float32 bound.
    work = (2.0 * M * N1 * (K + N2), 4.0 * (M * K + K * N1 + N1 * N2 + M * N2))
    b, by = bound_ms(*work)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
               bound_by=by, library_ms=library,
               device_ms=device_ms(kernel, 10), host_ab=host_ab)
    print(f"  vgg16 head mmchain {M}x{K}x{N1}x{N2}: kernel {ms:.4f} ms "
          f"(device {out['device_ms']:.4f})  plain {plain:.4f}  library "
          f"{library:.4f}  {bound_text(out)}")
    return out


def conv_route_shapes(program) -> list:
    """(C, CO, H) of each routed pad -> conv -> relu chain, read from the
    lowered program's routes: x from the pad task, w from the conv."""
    graph = program.graph
    shapes = []
    for group in program.lower().groups:
        for route in group.routes:
            if route.kernel != "streamfuse.conv":
                continue
            pad_t, conv_t = (graph.task(t) for t in route.tasks[:2])
            x = graph.buffers[pad_t.spec.ins[0]].shape
            w = graph.buffers[conv_t.spec.ins[1]].shape
            if x[2] != x[3] or w[2:] != (3, 3):
                fail(f"unexpected conv route shape x {x}, w {w}")
            shapes.append((x[1], w[0], x[2]))
    return shapes


def cnn_path(model: str, N: int, routes) -> dict:
    """codo_torch.compile(<model>_fn, (N, 3, 224, 224)) under forced
    routing, fan-in-scaled seeded weights (random_inputs) bound through
    params_from_numpy: the routed groups asserted, four requests with the
    launch counters zeroed just before and read just after, verify() on
    the card, and (N = 1) the card against the port on the CPU."""
    from collections import Counter

    import numpy as np
    import torch

    import codo_torch
    from repro_torch.kernels.flashattn import LIBRARY as FLASH
    from repro_torch.kernels.streamfuse import CONV_LIBRARY as CONVLIB
    from repro_torch.kernels.streamfuse import GRAD_LIBRARY as GRAD
    from repro_torch.kernels.streamfuse import LIBRARY as CHAIN
    from repro_torch.kernels.streamfuse.chain import chain_launches
    from repro_torch.kernels.streamfuse.streamfuse import conv_launches
    from repro_torch.models import dataflow_models as dm

    fn = getattr(dm, f"{model}_fn")
    shape = (N, 3, IMAGE, IMAGE)
    t0 = time.perf_counter()
    program = codo_torch.compile(fn, shape)
    env = dm.random_inputs(program.graph, seed=SEED + 20 + N)
    weights = {k: v for k, v in env.items()
               if program.graph.buffers[k].kind == "weight"}
    if len({w.tobytes() for w in weights.values()}) != len(weights):
        fail(f"{model}: bound weights are not distinct")
    program.bind(**codo_torch.params_from_numpy(weights, program.graph,
                                                program.device))
    routed = Counter(g.kernel for g in program.lower().groups if g.routes)
    compile_s = time.perf_counter() - t0
    want = ({CONV: len(routes)} if model == "resnet18"
            else {CONV: len(routes), MMCHAIN: 1})
    if routed != want:
        fail(f"{model} N={N}: expected routed groups {want}, got "
             f"{dict(routed)}")
    if sorted(conv_route_shapes(program)) != sorted(routes):
        fail(f"{model} N={N}: route shapes {conv_route_shapes(program)} are "
             f"not {routes}")
    rng = np.random.default_rng(SEED + 30 + N)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(REQUESTS)]
    program(xs[0], jit=False)                       # warm (allocator, libs)
    torch.cuda.synchronize()

    zero_counts()
    outs, walls = [], []
    for x in xs:
        t = time.perf_counter()
        y = program(x, jit=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        outs.append(y)
    conv_calls = CONVLIB.entry_launches["codo_pad_conv_relu"]
    launches = {"conv": conv_calls, "conv_all": CONVLIB.launches,
                "mmchain": CHAIN.launches, "flash": FLASH.launches,
                "mmgrad": GRAD.launches}

    for y in outs:
        if tuple(y.shape) != (N, 1000) or not bool(torch.isfinite(y).all()):
            fail(f"{model} N={N}: output not finite or not ({N}, 1000)")
    if len({float(y.double().sum()) for y in outs}) != REQUESTS:
        fail(f"{model} N={N}: distinct requests gave identical outputs")
    per_request = sum(conv_launches((N, C, H, H), (CO, C, 3, 3))
                      for C, CO, H in routes)
    if (conv_calls != REQUESTS * len(routes)
            or CONVLIB.launches != REQUESTS * per_request):
        fail(f"{model} N={N}: conv launches {launches}, expected "
             f"{REQUESTS} x {len(routes)} kernel calls and {REQUESTS} x "
             f"{per_request} launches in all")
    head = chain_launches(*VGG_HEAD) if model == "vgg16" else 0
    if launches["mmchain"] != REQUESTS * head:
        fail(f"{model}: the head's chain kernel ran {launches['mmchain']} "
             f"launches in {REQUESTS} requests, expected {REQUESTS * head}")
    if launches["flash"] or launches["mmgrad"]:
        fail(f"{model}: a kernel off the path launched: {launches}")
    program.verify(xs[1], rtol=VERIFY_BAND, atol=VERIFY_BAND)
    env = program.make_env(xs[1])
    got = program.lower(jit=False)(env)[program.output_names[0]]
    ref = program.source.execute(env)[program.output_names[0]]
    err, scale = max_err(got, ref), float(ref.abs().max())
    print(f"  {model} N={N}: groups {dict(routed)}; {REQUESTS} requests, "
          f"wall {', '.join(f'{w:.3f}' for w in walls)} ms; launches "
          f"{launches}; verify max_abs_err {err:.3e} (output scale "
          f"{scale:.3f}) within {VERIFY_BAND:.0e}")
    result = {"model": model, "N": N, "groups": dict(routed),
              "compile_s": compile_s, "request_ms": walls,
              "launches": launches, "conv_launches_per_request": per_request,
              "verify_max_abs_err": err, "verify_scale": scale,
              "verify_band": VERIFY_BAND}
    if N == 1:
        cpu = codo_torch.compile(fn, shape, device="cpu")
        cpu.bind(**weights)
        cpu_err = max_err(outs[0].cpu(), cpu(xs[0]))
        print(f"  {model} N={N}: card vs the port on the CPU max_abs_err "
              f"{cpu_err:.3e}")
        if not cpu_err <= VERIFY_BAND * (1 + float(outs[0].abs().max())):
            fail(f"{model}: card and CPU disagree ({cpu_err:.3e})")
        result["cpu_max_abs_err"] = cpu_err
    env = program.make_env(xs[2])
    run = program.lower(jit=False)
    result["profile"] = profile_device(lambda: run(env))
    return result


def measure_flash(record: dict, name: str, q, k, v, iters: int) -> dict:
    """Flash at a route's operands with gpt2_block's score scale: held
    against its plain version, timed beside it and SDPA, with its bound
    and profiled device time."""
    import torch
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    kw = dict(causal=False, window=0, scale=C)
    err = check(record["checks"], name, flash_attention(q, k, v, **kw),
                flash_attention_plain(q, k, v, **kw), TOL["f32_wide"])
    ms, plain = in_turns(lambda: flash_attention_plain(q, k, v, **kw),
                         lambda: flash_attention(q, k, v, **kw), iters)
    library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=C), iters)
    B, H, S, hd = q.shape
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=library,
                **tf32x3_bound(4.0 * B * H * S * S * hd,
                               4.0 * 4 * B * H * S * hd),
                device_ms=device_ms(lambda: flash_attention(q, k, v, **kw),
                                    iters))


def measure_kernels(S: int, record: dict) -> dict:
    """Kernel, plain and library times at the main path's shapes for S,
    the kernel's profiled device time, and the max error there."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                fused_matmul_grad,
                                                matmul_chain_plain,
                                                matmul_grad_plain)
    from repro_torch.kernels.streamfuse.chain import ChainTail, GradTail
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    iters = 20 if S <= 128 else 5
    out = {}

    out["flash"] = measure_flash(record, f"flash route 1x1x{S}x{D_MODEL} "
                                 f"scale={C}", *flash_route_operands(S, g),
                                 iters)

    a, w1, w2 = chain_route_operands(S, g)
    err = check(record["checks"], f"mmchain route {S}x{D_MODEL}x"
                f"{4 * D_MODEL}x{D_MODEL} gelu",
                fused_matmul_chain(a, w1, w2, ew=GELU),
                matmul_chain_plain(a, w1, w2, ew=GELU), TOL["f32_wide"])
    gelu = ChainTail(GELU)              # built once, as the route does
    ms, plain = in_turns(lambda: matmul_chain_plain(a, w1, w2, ew=GELU),
                         lambda: fused_matmul_chain(a, w1, w2, ew=gelu), iters)

    def library_chain():
        h = torch.nn.functional.gelu(a @ w1, approximate="tanh")
        return h @ w2

    library = time_ms(library_chain, iters)
    n1 = 4 * D_MODEL
    work = (2.0 * S * n1 * (D_MODEL + D_MODEL),
            4.0 * (S * D_MODEL + D_MODEL * n1 + n1 * D_MODEL + S * D_MODEL))
    out["mmchain"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          library_ms=library, **tf32x3_bound(*work),
                          device_ms=device_ms(lambda: fused_matmul_chain(
                              a, w1, w2, ew=gelu), iters))

    for chain, (a, w, e, ew) in grad_route_operands(S, g).items():
        M, K, N = a.shape[0], a.shape[1], w.shape[1]
        tail = GradTail(ew, 1)          # built once, as the route does
        err = check(record["checks"], f"mmgrad route {chain} {M}x{K}x{N}",
                    fused_matmul_grad(a, w, e, ew=tail),
                    matmul_grad_plain(a, w, e, ew=ew), TOL["f32_wide"])
        ms, plain = in_turns(lambda: matmul_grad_plain(a, w, e, ew=ew),
                             lambda: fused_matmul_grad(a, w, e, ew=tail),
                             iters)
        # The same calls with the tail's codes built every call.
        ms_again, ms_stages = in_turns(
            lambda: fused_matmul_grad(a, w, e, ew=ew),
            lambda: fused_matmul_grad(a, w, e, ew=tail), iters)
        if chain == "ffn":
            def library_grad():
                return torch.ops.aten.gelu_backward(a @ w, e,
                                                    approximate="tanh")
        else:
            def library_grad():
                return torch._softmax_backward_data(
                    a @ w, e, -1, torch.float32) * C
        library = time_ms(library_grad, iters)
        flops, nbytes = 2.0 * M * N * K, 4.0 * (M * K + K * N + 2 * M * N)
        out[f"mmgrad_{chain}"] = dict(
            flops=flops, bytes=nbytes,
            max_abs_err=err, ms=ms, plain_ms=plain,
            **tf32x3_bound(flops, nbytes),
            library_ms=library, device_ms=device_ms(
                lambda: fused_matmul_grad(a, w, e, ew=tail), iters),
            ms_prepared_again=ms_again, ms_codes_each_call=ms_stages)
        print(f"  S={S} mmgrad_{chain}: tail built once {ms_again:.4f} ms "
              f"a call, its codes built each call {ms_stages:.4f} ms")
    for name, m in out.items():
        print(f"  S={S} {name:<11s} kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f})  plain {m['plain_ms']:.4f} ms  library "
              f"{m['library_ms']:.4f} ms  {bound_text(m)}")
    return out


def main_path(S: int, record: dict) -> dict:
    """codo_torch.compile(gpt2_block_fn, (S, D)) under forced routing:
    four requests with the launch counters zeroed just before, then
    verify() on the card."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.kernels.flashattn import LIBRARY as FLASH
    from repro_torch.kernels.flashattn.flashattn import flash_launches
    from repro_torch.kernels.streamfuse import LIBRARY as CHAIN
    from repro_torch.kernels.streamfuse.chain import chain_launches
    from repro_torch.models.dataflow_models import gpt2_block_fn

    t0 = time.perf_counter()
    program = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    rng = np.random.default_rng(SEED + S)
    weights = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                        ).astype(np.float32) for b in program.graph.weights()}
    if len({w.tobytes() for w in weights.values()}) != len(weights):
        fail("bound weights are not distinct")
    program.bind(**codo_torch.params_from_numpy(weights, program.graph,
                                                program.device))
    kernels = [g.kernel for g in program.lower().groups]
    compile_s = time.perf_counter() - t0
    if kernels != ["pallas:flashattn.mha+streamfuse.mmchain"]:
        fail(f"S={S}: expected one group routed to both kernels, got "
             f"{kernels}")
    xs = [rng.standard_normal((S, D_MODEL)).astype(np.float32)
          for _ in range(REQUESTS)]
    program(xs[0], jit=False)                       # warm (allocator, libs)
    torch.cuda.synchronize()

    zero_counts()
    outs, walls = [], []
    for x in xs:
        t = time.perf_counter()
        y = program(x, jit=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        outs.append(y)
    launches = {"flash": FLASH.launches, "mmchain": CHAIN.launches}

    for y in outs:
        if tuple(y.shape) != (S, D_MODEL) or not bool(torch.isfinite(y).all()):
            fail(f"S={S}: output not finite or not ({S}, {D_MODEL})")
    if len({float(y.double().sum()) for y in outs}) != REQUESTS:
        fail(f"S={S}: distinct requests gave identical outputs")
    want = {"flash": REQUESTS * flash_launches(S, S, 1, D_MODEL),
            "mmchain": REQUESTS * chain_launches(S, D_MODEL, 4 * D_MODEL,
                                                 D_MODEL)}
    if launches != want:
        fail(f"S={S}: launches {launches}, expected {want}")
    program.verify(xs[1], rtol=VERIFY_BAND, atol=VERIFY_BAND)
    env = program.make_env(xs[1])
    err = max_err(program.lower(jit=False)(env)[program.output_names[0]],
                  program.source.execute(env)[program.output_names[0]])
    print(f"  S={S}: group {kernels[0]}; {REQUESTS} requests, wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; launches {launches}; "
          f"verify max_abs_err {err:.3e} within {VERIFY_BAND:.0e} (pinned at "
          f"{GPT2_VERIFY_PIN[S]:.1e})")
    if not err <= GPT2_VERIFY_PIN[S]:
        fail(f"S={S}: verify max_abs_err {err:.3e} above its pin "
             f"{GPT2_VERIFY_PIN[S]:.1e}: the tensor cores' accumulation is "
             f"back")
    result = {"S": S, "kernels": kernels, "compile_s": compile_s,
              "request_ms": walls, "launches": launches,
              "verify_max_abs_err": err, "verify_band": VERIFY_BAND}
    if S == SEQS[0]:
        # The same program on the CPU (plain versions): same answer.
        cpu = codo_torch.compile(gpt2_block_fn, (S, D_MODEL), device="cpu")
        cpu.bind(**weights)
        cpu_err = max_err(outs[0].cpu(), cpu(xs[0]))
        print(f"  S={S}: card vs the port on the CPU max_abs_err "
              f"{cpu_err:.3e}")
        if not cpu_err <= VERIFY_BAND * (1 + float(outs[0].abs().max())):
            fail(f"S={S}: card and CPU disagree ({cpu_err:.3e})")
        result["cpu_max_abs_err"] = cpu_err
    env = program.make_env(xs[2])
    run = program.lower(jit=False)
    result["profile"] = profile_device(lambda: run(env))
    return result


# Each call whose profile held no device activity in four tries: its
# caller and the CUDA-event time that stands in for its device time.
PROFILER_MISSES: list = []


def device_rows(run) -> list:
    """Device time by kernel name over one call of ``run`` (torch.profiler;
    up to three more tries when one records no device activity, which the
    card's tracing does now and then).  When all four record nothing, one
    more call is timed with CUDA events and returned as one row named
    ``PROFILER_MISS_ROW``: the span from its first launch to its last
    kernel's end, the device's idle gaps inside it included, so an upper
    bound on its device time.  The miss is printed and kept in
    ``PROFILER_MISSES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rows: list = []
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = getattr(e, "cuda_time_total", 0.0)
            if dev and getattr(e, "device_type", None) == \
                    torch.autograd.DeviceType.CUDA:
                rows.append({"name": e.key[:80], "count": e.count,
                             "device_us": float(dev)})
        if rows:
            break
        time.sleep(0.5)
    if not rows:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        us = 1e3 * start.elapsed_time(end)
        frame = sys._getframe(1)
        while frame.f_code.co_name in PROFILING_HELPERS:
            frame = frame.f_back
        caller = frame.f_code.co_name
        PROFILER_MISSES.append({"caller": caller, "events_us": us})
        print(f"    {caller}: the profiler recorded no device time in four "
              f"tries; its device time here is CUDA events around one call, "
              f"{us:.1f} us (idle gaps included)")
        rows = [{"name": PROFILER_MISS_ROW, "count": 1, "device_us": us}]
    rows.sort(key=lambda r: -r["device_us"])
    return rows


PROFILER_MISS_ROW = "(CUDA events: the profiler recorded nothing)"
# The helpers over device_rows: a miss is named by the phase calling them.
PROFILING_HELPERS = ("device_ms", "profile_device", "wall_and_device",
                     "<lambda>", "<listcomp>")


def device_ms(fn, iters: int) -> float:
    """Profiled device time of one call of ``fn``, mean over ``iters``
    calls: beside the CUDA-event time, which holds the host's share where
    a call's host work outlasts its kernels."""
    rows = device_rows(lambda: [fn() for _ in range(iters)])
    return sum(r["device_us"] for r in rows) / iters / 1e3


def profile_device(run, calls: int = 1) -> list:
    """Device time by kernel name over one call of ``run``, printed; with
    ``calls``, ``run`` makes that many requests and the rows are per
    request."""
    rows = device_rows(run)
    for r in rows:
        r["device_us"] /= calls
    total = sum(r["device_us"] for r in rows)
    print(f"    profile: {total:.1f} us on the device, by kernel: "
          + "; ".join(f"{r['name'][:40]} {r['device_us']:.1f} us"
                      for r in rows[:6]))
    return rows


def _to_host(tree):
    """Every tensor of a nest of dicts and tuples, copied to the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    return tree.detach().cpu()


def scaled(name: str, err: float, scale: float, tol: float) -> float:
    """``err`` over ``scale``, failing past ``tol``."""
    if not scale > 0.0:
        fail(f"{name}: the reference is zero")
    rel = err / scale
    if not rel <= tol:
        fail(f"{name}: error {err:.3e} is {rel:.2e} of the reference's "
             f"scale {scale:.3e}, band {tol:.0e}")
    return rel


def _close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch
    err = max_err(got, want)
    if not bool(torch.allclose(got.float(), want.float(), rtol=rtol,
                               atol=atol)):
        fail(f"{name}: card and CPU disagree (max abs err {err:.3e}, "
             f"rtol {rtol:.0e}, atol {atol:.1e})")
    return err


def train_path(S: int) -> dict:
    """codo_torch.compile(gpt2_block_loss_fn, (S, D), (S, D), grad=True)
    under forced routing: the backward routed to exactly two mmgrad
    groups; a warm step, then four steps with the launch counters zeroed
    just before and read just after; verify() on the card; and (S=128)
    one step against the same step of the port on the CPU."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.kernels.flashattn import LIBRARY as FLASH
    from repro_torch.kernels.streamfuse import GRAD_LIBRARY as GRAD
    from repro_torch.kernels.streamfuse import LIBRARY as CHAIN
    from repro_torch.kernels.streamfuse.chain import grad_launches
    from repro_torch.models.dataflow_models import gpt2_block_loss_fn

    t0 = time.perf_counter()
    step = codo_torch.compile(gpt2_block_loss_fn, (S, D_MODEL), (S, D_MODEL),
                              grad=True)
    groups = {ph: [g.kernel for g in getattr(step, ph).lower().groups
                   if g.routes] for ph in PHASES}
    compile_s = time.perf_counter() - t0
    if groups != {"forward": [], "backward": [MMGRAD, MMGRAD], "update": []}:
        fail(f"S={S}: expected exactly two {MMGRAD} groups in the backward "
             f"and none elsewhere, got {groups}")
    rng = np.random.default_rng(SEED + 10 + S)
    params = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                       ).astype(np.float32) for b in step.source.weights()}
    if len({w.tobytes() for w in params.values()}) != len(params):
        fail("train parameters are not distinct")
    zero = {"m": {w: np.zeros_like(v) for w, v in params.items()},
            "v": {w: np.zeros_like(v) for w, v in params.items()},
            "step": np.zeros((), np.int32)}
    x, target = (rng.standard_normal((S, D_MODEL)).astype(np.float32)
                 for _ in range(2))
    p, s = codo_torch.train_state_from_numpy(params, zero, step)
    xt, tt = (torch.as_tensor(v, device="cuda") for v in (x, target))
    p1, s1, m1 = step.step(p, s, xt, tt, jit=False)           # warm (allocator, libs)
    torch.cuda.synchronize()

    zero_counts()
    walls, metrics = [], []
    q, u = p1, s1
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        q, u, m = step.step(q, u, xt, tt, jit=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        metrics.append(m)
    launches = {"flash": FLASH.launches, "mmchain": CHAIN.launches,
                "mmgrad": GRAD.launches}

    per_step = (grad_launches(S, 4 * D_MODEL, D_MODEL, GELU_GRAD)
                + grad_launches(S, S, D_MODEL, SOFTMAX_GRAD))
    if launches["mmgrad"] != TRAIN_STEPS * per_step:
        fail(f"S={S}: the mmgrad kernel launched {launches['mmgrad']} "
             f"times in {TRAIN_STEPS} steps, expected {TRAIN_STEPS} x "
             f"{per_step}")
    values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if not all(math.isfinite(v) for vs in values.values() for v in vs):
        fail(f"S={S}: non-finite metrics {values}")
    if int(u["step"]) != 1 + TRAIN_STEPS:
        fail(f"S={S}: step counter {int(u['step'])}")
    for w in step.param_names:
        if not bool(torch.isfinite(q[w]).all()) or bool((q[w] == p[w]).all()):
            fail(f"S={S}: parameter {w} not finite or not updated")
    verify = step.verify(xt, tt, params=p, **TRAIN_BAND)
    rel = {w: scaled(f"S={S} verify grad {w}", *verify[w], GRAD_TOL)
           for w in step.param_names}
    print(f"  S={S}: backward groups {groups['backward']}; {TRAIN_STEPS} "
          f"steps, wall {', '.join(f'{w:.3f}' for w in walls)} ms; "
          f"launches {launches}; loss {values['loss'][0]:.6f} -> "
          f"{values['loss'][-1]:.6f}; verify within rtol "
          f"{TRAIN_BAND['rtol']:.0e} / atol {TRAIN_BAND['atol']:.0e}, each "
          f"gradient within {max(rel.values()):.2e} of its max (band "
          f"{GRAD_TOL:.0e})")
    result = {"S": S, "groups": groups, "compile_s": compile_s,
              "step_ms": walls, "launches": launches,
              "launches_per_step": per_step, "metrics": values,
              "verify_band": TRAIN_BAND, "verify": verify,
              "verify_grad_rel_err": rel, "grad_tol": GRAD_TOL}
    if S == SEQS[0]:
        result["cpu"] = train_card_vs_cpu(
            f"S={S}", gpt2_block_loss_fn, [(S, D_MODEL)] * 2, None, params,
            zero, {"x": x, "target": target}, (p1, s1, m1))
    result["profile"] = profile_device(lambda: step.step(q, u, xt, tt, jit=False))
    return result


def train_card_vs_cpu(name: str, fn, specs, wrt, params, zero, named,
                      card) -> dict:
    """The first step from the same state on the card and by the port on
    the CPU (plain versions) of ``codo_torch.compile(fn, *specs,
    grad=True, wrt=wrt)``, the inputs ``named`` passed by name.  Bands:
    loss and gradient norm rtol 2e-3 (the verify band), lr 1e-6; m and v
    each within GRAD_TOL (v twice) of its largest value; the update p1 -
    p0 within UPDATE_TOL in norm."""
    import torch

    import codo_torch
    cpu = codo_torch.compile(fn, *specs, grad=True, wrt=wrt, device="cpu")
    p, s = codo_torch.train_state_from_numpy(params, zero, cpu)
    want = cpu.step(p, s, **named)
    (cp, cs, cm), (wp, ws, wm) = _to_host(card), want
    errs = {"loss": _close("loss", cm["loss"], wm["loss"], 2e-3, 0.0),
            "grad_norm": _close("grad_norm", cm["grad_norm"],
                                wm["grad_norm"], 2e-3, 0.0),
            "lr": _close("lr", cm["lr"], wm["lr"], 1e-6, 0.0)}
    for w in cpu.param_names:
        for key, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
            got, ref = cs[key][w], ws[key][w]
            errs[f"{key} {w}"] = scaled(
                f"{name} {key} {w}", max_err(got, ref),
                float(ref.abs().max()), tol)
        p0 = torch.as_tensor(params[w])
        step_card, step_cpu = cp[w] - p0, wp[w] - p0
        norm = float(step_cpu.double().norm())
        errs[f"dp {w}"] = scaled(
            f"{name} update {w}",
            float((step_card - step_cpu).double().norm()),
            norm, UPDATE_TOL)
    if not int(cs["step"]) == int(ws["step"]) == 1:
        fail("step counters disagree")
    worst = {k: max(v for n, v in errs.items() if n.split()[0] == k)
             for k in ("dp", "m", "v")}
    print(f"  {name}: one step, card vs the port on the CPU: loss "
          f"{errs['loss']:.3e}, grad_norm {errs['grad_norm']:.3e}, lr "
          f"{errs['lr']:.1e} (max abs); relative to each tensor: m "
          f"{worst['m']:.2e}, v {worst['v']:.2e} (of the max, bands "
          f"{GRAD_TOL:.0e}, {2 * GRAD_TOL:.0e}), update p1-p0 "
          f"{worst['dp']:.2e} (in norm, band {UPDATE_TOL:.0e})")
    return {"errors": errs, "grad_tol": GRAD_TOL, "update_tol": UPDATE_TOL}


def gates(shape, g, lo: float, hi: float):
    """Uniform values in [lo, hi) on the card: a recurrence's gates or
    decays, in the model's domain (a standard normal is not a gate)."""
    import torch
    return lo + (hi - lo) * torch.rand(*shape, generator=g, device="cuda")


def rglru_operands(B, S, D, g, dtype=None):
    """a in [0.5, 0.999), b = 0.1·N(0, 1): the reference sweep's domain."""
    import torch
    a = gates((B, S, D), g, 0.5, 0.999)
    b = 0.1 * torch.randn(B, S, D, generator=g, device="cuda")
    return (a, b) if dtype is None else (a.to(dtype), b.to(dtype))


def ssd_operands(nc, BH, P, N, g):
    """states 0.1·N(0, 1), decays in [0.5, 0.99): the sweep's domain."""
    import torch
    st = 0.1 * torch.randn(nc, BH, P, N, generator=g, device="cuda")
    return st, gates((nc, BH, 1, 1), g, 0.5, 0.99)


def check_slice(record: list) -> None:
    """The four kernels of the recurrence / attention-tail slice against
    their plain versions: the reference sweep's shapes, ragged edges and
    the route shapes, ssd's reverse kernel too (twice bit for bit); rglru
    also across chunk lengths, one launch a call
    and twenty calls bit for bit the same at the route, and a grid far
    larger than the card's resident blocks; the tail with a
    transposed s and N wider than a block's columns, matmul in bfloat16
    and against torch.matmul, its route shape twice (bit for bit the
    same) and in bfloat16."""
    import torch
    from repro_torch.kernels.matmul import matmul_plain, mm
    from repro_torch.kernels.rglru import LIBRARY as LIBRARY_RGLRU
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.kernels.rglru.rglru import (STATE_HEADER, chunk_length,
                                                 state_words)
    from repro_torch.kernels.ssd import (ssd_chunk_scan,
                                         ssd_chunk_scan_backward,
                                         ssd_chunk_scan_backward_plain,
                                         ssd_chunk_scan_plain)
    from repro_torch.kernels.streamfuse import (fused_softmax_matmul,
                                                softmax_matmul_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    for B, S, D, chunk in [(2, 256, 64, 128), (1, 128, 128, 32),
                           (3, 64, 32, 64), (2, 100, 40, 16),
                           (2, 77, 24, 128)]:
        a, b = rglru_operands(B, S, D, g)
        check(record, f"rglru {B}x{S}x{D} chunk={chunk}",
              rglru_scan(a, b, chunk=chunk),
              rglru_scan_plain(a, b, chunk=chunk), RGLRU_TOL)
    a, b = rglru_operands(2, 256, 64, g, torch.bfloat16)
    check(record, "rglru 2x256x64 chunk=64 bf16", rglru_scan(a, b, chunk=64),
          rglru_scan_plain(a, b, chunk=64), TOL["bf16"])
    a, b = rglru_operands(*RGLRU_SHAPE, g)
    route = chunk_length(*RGLRU_SHAPE)
    plain = rglru_scan_plain(a, b, chunk=route)
    for chunk in (route, 128, 2048):
        check(record, f"rglru route {'x'.join(map(str, RGLRU_SHAPE))} "
              f"chunk={chunk}", rglru_scan(a, b, chunk=chunk), plain,
              RGLRU_TOL)
    # One launch a call, and twenty calls in a row bit for bit the same:
    # the kernel's flags, ticket and epoch ready themselves for the next
    # call with nothing from the host.
    LIBRARY_RGLRU.reset_counts()
    first = rglru_scan(a, b, chunk=route)
    again = [rglru_scan(a, b, chunk=route) for _ in range(RGLRU_REPEATS - 1)]
    calls = dict(LIBRARY_RGLRU.entry_launches)
    ok = calls == {"codo_rglru_scan": RGLRU_REPEATS}
    record.append({"case": "rglru route launches a call", "launches": calls,
                   "calls": RGLRU_REPEATS, "ok": ok})
    if not ok:
        fail(f"rglru_scan: expected one launch a call over {RGLRU_REPEATS} "
             f"calls, got {calls}")
    ok = all(torch.equal(first, h) for h in again)
    record.append({"case": f"rglru route {RGLRU_REPEATS} calls in a row",
                   "bit_identical": ok, "ok": ok})
    print(f"  rglru route: {RGLRU_REPEATS} calls in a row, one launch each "
          f"({calls}), bit-identical {ok}")
    if not ok:
        fail(f"rglru_scan: {RGLRU_REPEATS} calls in a row differ")
    del a, b, plain, first, again
    # A grid far larger than the card holds resident, so that blocks wait
    # on chunks whose blocks started waves earlier (3 × 512 MiB).
    a, b = rglru_operands(*RGLRU_BIG, g)
    chunk = chunk_length(*RGLRU_BIG)
    blocks = state_words(*RGLRU_BIG, chunk) - STATE_HEADER
    check(record, f"rglru {'x'.join(map(str, RGLRU_BIG))} chunk={chunk} "
          f"({blocks} blocks)", rglru_scan(a, b, chunk=chunk),
          rglru_scan_plain(a, b, chunk=chunk), RGLRU_TOL)
    del a, b
    for shape in [(8, 4, 16, 32), (4, 8, 8, 16), (16, 2, 32, 8), (5, 3, 7, 9),
                  SSD_SHAPE]:
        st, dec = ssd_operands(*shape, g)
        route = " route" if shape == SSD_SHAPE else ""
        check(record, f"ssd{route} {'x'.join(map(str, shape))}",
              ssd_chunk_scan(st, dec), ssd_chunk_scan_plain(st, dec), SSD_TOL)
    # The reverse kernel at the sweep's shapes, P·N past one cluster's
    # 8192 elements (nine and sixteen 1024-element groups over eight
    # blocks), the route, and bfloat16 (ragged P·N too): both outputs
    # against the plain reverse loop within each one's scale, twice on the
    # same operands bit for bit (ddecay summed in a fixed order); a
    # non-contiguous cotangent raises (no fallback).
    for shape, dtype in [((8, 4, 16, 32), torch.float32),
                         ((4, 8, 8, 16), torch.float32),
                         ((16, 2, 32, 8), torch.float32),
                         ((5, 3, 7, 9), torch.float32),
                         ((3, 2, 64, 130), torch.float32),
                         ((6, 5, 64, 256), torch.float32),
                         (SSD_SHAPE, torch.float32),
                         ((7, 4, 8, 16), torch.bfloat16),
                         ((5, 3, 7, 9), torch.bfloat16)]:
        st, dec = (t.to(dtype) for t in ssd_operands(*shape, g))
        h = ssd_chunk_scan(st, dec)
        cot = (0.1 * rn(*shape)).to(dtype)
        text = "x".join(map(str, shape)) + f" {str(dtype)[6:]}"
        got = ssd_chunk_scan_backward(cot, dec, h)
        tol = TOL["f32"] if dtype == torch.float32 else TOL["bf16"]
        for part, a, b in zip(("dstates", "ddecay"), got,
                              ssd_chunk_scan_backward_plain(cot, dec, h)):
            check_scaled(record, f"ssd_backward {text} {part}", a, b, tol)
        again = ssd_chunk_scan_backward(cot, dec, h)
        same(record, f"ssd_backward {text}", torch.cat(
            [t.flatten() for t in got]), torch.cat(
            [t.flatten() for t in again]))
        if not record[-1]["ok"]:
            fail(f"ssd_chunk_scan_backward {text}: two calls differ")
    loose = cot.transpose(2, 3).contiguous().transpose(2, 3)
    try:
        ssd_chunk_scan_backward(loose, dec, h)
    except ValueError as e:
        print(f"  ssd_backward on a non-contiguous cotangent raises: {e}")
    else:
        fail("ssd_chunk_scan_backward took a non-contiguous cotangent")
    for M, K, N in [(128, 256, 64), (256, 128, 32), (64, 64, 96)]:
        for dtype, tol in [(torch.float32, TOL["f32"]),
                           (torch.bfloat16, TOL["bf16"])]:
            sv, v = (2 * rn(M, K)).to(dtype), rn(K, N).to(dtype)
            check(record, f"softmaxmm {M}x{K}x{N} {str(dtype)[6:]}",
                  fused_softmax_matmul(sv, v), softmax_matmul_plain(sv, v),
                  tol)
    for name, sv, v in [("ragged 100x77x50", rn(100, 77), rn(77, 50)),
                        ("sT 50x77x30", rn(77, 50).t(), rn(77, 30)),
                        ("wide 64x64x600", rn(64, 64), rn(64, 600))]:
        check(record, f"softmaxmm {name}", fused_softmax_matmul(sv, v),
              softmax_matmul_plain(sv, v), TOL["f32"])
    # 64-column tiles walking several key tiles a split (the 64-column
    # form that folds each key tile in), in both types.
    for dtype, tol in [(torch.float32, TOL["f32_wide"]),
                       (torch.bfloat16, TOL["bf16"])]:
        sv, v = rn(4096, 1024).to(dtype), rn(1024, 64).to(dtype)
        check(record, f"softmaxmm 4096x1024x64 {str(dtype)[6:]}",
              fused_softmax_matmul(sv, v), softmax_matmul_plain(sv, v), tol)
    # The route's shapes, each called twice (bit for bit the same), and
    # each in bfloat16.
    for M, K, N in TAIL_SHAPES:
        sv, v = rn(M, K), rn(K, N)
        name = f"softmaxmm route {M}x{K}x{N}"
        got, want = fused_softmax_matmul(sv, v), softmax_matmul_plain(sv, v)
        check(record, name, got, want, TOL["f32_wide"])
        same(record, name, got, fused_softmax_matmul(sv, v))
        sv, v = sv.bfloat16(), v.bfloat16()
        got = fused_softmax_matmul(sv, v)
        check(record, f"{name} bf16", got, softmax_matmul_plain(sv, v),
              TOL["bf16"])
        same(record, f"{name} bf16", got, fused_softmax_matmul(sv, v))
    for M, N, K in [(128, 128, 128), (256, 128, 384), (128, 384, 256),
                    (512, 128, 128), (100, 130, 77)]:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = rn(M, K).to(dtype), rn(K, N).to(dtype)
            key = "f32" if dtype == torch.float32 else "bf16"
            check(record, f"matmul {M}x{K}x{N} {key}", mm(a, b),
                  matmul_plain(a, b), MM_TOL[key])
    M, K, N = MM_SHAPE
    a, b = rn(M, K) / math.sqrt(K), rn(K, N)
    got = mm(a, b)
    name = f"matmul route {M}x{K}x{N}"
    check(record, name, got, matmul_plain(a, b), MM_TOL["f32"])
    check(record, f"{name} vs torch.matmul", got, torch.matmul(a, b),
          MM_TOL["f32"])
    same(record, name, got, mm(a, b))
    a, b = a.bfloat16(), b.bfloat16()
    got = mm(a, b)
    check(record, f"{name} bf16", got, matmul_plain(a, b), MM_TOL["bf16"])
    same(record, f"{name} bf16", got, mm(a, b))


def measure_slice(record: dict) -> dict:
    """Each slice kernel at its route shape: event and profiled device
    time, plain time, the bound and the library yardstick (none for the
    scans: no single PyTorch call computes a linear recurrence)."""
    import torch
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    from repro_torch.kernels.matmul import matmul_plain, mm
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.kernels.rglru.rglru import chunk_length
    from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunk_scan_plain
    from repro_torch.kernels.streamfuse import (fused_softmax_matmul,
                                                softmax_matmul_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    iters = 10
    out = {}

    def record_one(name, kernel, plain, library, flops, nbytes, err):
        ms, plain_ms = in_turns(plain, kernel, iters)
        b, by = bound_ms(flops, nbytes)
        m = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                 bound_by=by, flops=flops, bytes=nbytes,
                 library_ms=None if library is None else time_ms(library,
                                                                 iters),
                 device_ms=device_ms(kernel, iters))
        lib = "none" if m["library_ms"] is None else f"{m['library_ms']:.4f}"
        print(f"  {name:<28s} kernel {ms:.4f} ms (device "
              f"{m['device_ms']:.4f})  plain {plain_ms:.4f}  library {lib}  "
              f"bound {b:.4f} ({by})")
        out[name] = m

    B, S, D = RGLRU_SHAPE
    a, b = rglru_operands(B, S, D, g)
    ch = chunk_length(B, S, D)
    n = B * S * D
    record_one("rglru", lambda: rglru_scan(a, b, chunk=ch),
               lambda: rglru_scan_plain(a, b, chunk=ch), None, 2.0 * n,
               4.0 * 3 * n, max_err(rglru_scan(a, b, chunk=ch),
                                    rglru_scan_plain(a, b, chunk=ch)))
    st, dec = ssd_operands(*SSD_SHAPE, g)
    n = st.numel()
    record_one("ssd", lambda: ssd_chunk_scan(st, dec),
               lambda: ssd_chunk_scan_plain(st, dec), None, 2.0 * n,
               4.0 * (2 * n + dec.numel()),
               max_err(ssd_chunk_scan(st, dec), ssd_chunk_scan_plain(st, dec)))
    BH, S, hd = MHA_SHAPE
    q, k, v = (torch.randn(BH, 1, S, hd, generator=g, device="cuda")
               for _ in range(3))
    kw = dict(causal=False, window=0, scale=1.0 / math.sqrt(hd))
    record_one("flash_mha", lambda: flash_attention(q, k, v, **kw),
               lambda: flash_attention_plain(q, k, v, **kw),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, scale=kw["scale"]),
               4.0 * BH * S * S * hd, 4.0 * 4 * BH * S * hd,
               max_err(flash_attention(q, k, v, **kw),
                       flash_attention_plain(q, k, v, **kw)))
    m = out["flash_mha"]
    m.update(tf32x3_bound(m["flops"], m["bytes"]))
    print(f"  {'flash_mha':<28s} {bound_text(m)}")
    for M, K, N in TAIL_SHAPES:
        sv = torch.randn(M, K, generator=g, device="cuda")
        vv = torch.randn(K, N, generator=g, device="cuda")
        name = f"softmaxmm_{M}x{K}x{N}"
        record_one(name, lambda: fused_softmax_matmul(sv, vv),
                   lambda: softmax_matmul_plain(sv, vv),
                   lambda: torch.softmax(sv, -1) @ vv,
                   2.0 * M * K * N + 4.0 * M * K, 4.0 * (M * K + K * N + M * N),
                   max_err(fused_softmax_matmul(sv, vv),
                           softmax_matmul_plain(sv, vv)))
        m = out[name]
        m.update(tf32x3_bound(m["flops"], m["bytes"]))
        exact = torch.softmax(sv.double(), -1) @ vv.double()
        m["f64_err"] = float(
            (fused_softmax_matmul(sv, vv).double() - exact).abs().max())
        print(f"  {name:<28s} {bound_text(m)}; against float64 "
              f"{m['f64_err']:.3e}")
    M, K, N = MM_SHAPE
    am = torch.randn(M, K, generator=g, device="cuda") / math.sqrt(K)
    bm = torch.randn(K, N, generator=g, device="cuda")
    record_one("matmul", lambda: mm(am, bm), lambda: matmul_plain(am, bm),
               lambda: torch.matmul(am, bm), 2.0 * M * N * K,
               4.0 * (M * K + K * N + M * N),
               max_err(mm(am, bm), matmul_plain(am, bm)))
    m = out["matmul"]
    m.update(tf32x3_bound(m["flops"], m["bytes"]))
    m["vs_library"] = m["ms"] / m["library_ms"]
    print(f"  {'matmul':<28s} {bound_text(m)}; {m['vs_library']:.2f}x "
          f"torch.matmul")
    return out


def attention_tail_fn(s, v):
    """The bare attention tail, ``matmul(softmax(s), v)`` with s an input:
    the graph that routes ``streamfuse.softmaxmm`` (no catalog model does:
    ``flashattn.mha`` claims the whole chain where the scores are made)."""
    from repro_torch.core import frontend as F
    return F.matmul(F.softmax(s), v)


def slice_workloads() -> list:
    """(name, function, shapes, the routed group, the library that must
    launch, its launches a request, seeded input maker) of each path of
    the slice."""
    import numpy as np

    from repro_torch.kernels.flashattn.flashattn import flash_launches
    from repro_torch.kernels.rglru.rglru import launches as rglru_launches
    from repro_torch.kernels.streamfuse.chain import softmax_mm_launches
    from repro_torch.models.rglru import rglru_block_fn
    from repro_torch.models.ssm import ssd_block_fn
    from repro_torch.models.transformer import mha_batched_fn

    def rglru_inputs(rng):
        a = rng.uniform(0.5, 0.999, RGLRU_SHAPE).astype(np.float32)
        gate = rng.uniform(0.0, 1.0, RGLRU_SHAPE).astype(np.float32)
        return [a, gate, rng.standard_normal(RGLRU_SHAPE).astype(np.float32)]

    def ssd_inputs(rng):
        nc, BH = SSD_SHAPE[:2]
        return [(0.1 * rng.standard_normal(SSD_SHAPE)).astype(np.float32),
                rng.uniform(0.5, 0.99, (nc, BH, 1, 1)).astype(np.float32)]

    def normals(*shapes):
        return lambda rng: [rng.standard_normal(s).astype(np.float32)
                            for s in shapes]

    nc, BH = SSD_SHAPE[:2]
    BH_MHA, S_MHA, HD_MHA = MHA_SHAPE
    out = [("rglru_block", rglru_block_fn, [RGLRU_SHAPE] * 3, RGLRU, "rglru",
            rglru_launches(), rglru_inputs),
           ("ssd_block", ssd_block_fn, [SSD_SHAPE, (nc, BH, 1, 1)], SSD,
            "ssd", 1, ssd_inputs),
           ("mha_batched", mha_batched_fn, [MHA_SHAPE] * 3, FLASH, "flash",
            flash_launches(S_MHA, S_MHA, BH_MHA, HD_MHA),
            normals(*[MHA_SHAPE] * 3))]
    for M, K, N in TAIL_SHAPES:
        out.append((f"attention_tail {M}x{K}x{N}", attention_tail_fn,
                    [(M, K), (K, N)], SOFTMAXMM, "softmaxmm",
                    softmax_mm_launches(M, K, N), normals((M, K), (K, N))))
    return out


def slice_path(seed, name, fn, shapes, group, lib_name, per_request,
               make_inputs) -> dict:
    """codo_torch.compile(fn, *shapes) under forced routing: the one
    routed group asserted, four requests with the launch counters zeroed
    just before and read just after (the slice's kernel and no other, its
    expected count a request), verify() on the card, the card against
    the port on the CPU, and one profiled request."""
    import numpy as np
    import torch

    import codo_torch
    t0 = time.perf_counter()
    program = codo_torch.compile(fn, *shapes)
    groups = [g.kernel for g in program.lower().groups if g.routes]
    compile_s = time.perf_counter() - t0
    if groups != [group]:
        fail(f"{name}: expected the one routed group {group}, got {groups}")
    rng = np.random.default_rng(seed)
    xs = [make_inputs(rng) for _ in range(REQUESTS)]
    # A layer's inputs come from the layer before it, on the card: they
    # are placed there as set-up, not copied in each request.
    dev = [[torch.as_tensor(a, device="cuda") for a in x] for x in xs]
    program(*dev[0], jit=False)                     # warm (allocator, libs)
    torch.cuda.synchronize()

    zero_counts()
    outs, walls = [], []
    for x in dev:
        t = time.perf_counter()
        y = program(*x, jit=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        outs.append(y)
    launches = {k: lib.launches for k, lib in all_libraries().items()}

    want_shape = tuple(program.graph.buffers[program.output_names[0]].shape)
    for y in outs:
        if tuple(y.shape) != want_shape or not bool(torch.isfinite(y).all()):
            fail(f"{name}: output not finite or not {want_shape}")
    if len({float(y.double().sum()) for y in outs}) != REQUESTS:
        fail(f"{name}: distinct requests gave identical outputs")
    if launches[lib_name] != REQUESTS * per_request or any(
            n for k, n in launches.items() if k != lib_name):
        fail(f"{name}: expected {REQUESTS} x {per_request} {lib_name} "
             f"launches and no other kernel, got {launches}")
    program.verify(*dev[1], rtol=VERIFY_BAND, atol=VERIFY_BAND)
    env = program.make_env(*dev[1])
    got = program.lower(jit=False)(env)[program.output_names[0]]
    ref = program.source.execute(env)[program.output_names[0]]
    err, scale = max_err(got, ref), float(ref.abs().max())
    cpu = codo_torch.compile(fn, *shapes, device="cpu")
    cpu_err = max_err(outs[0].cpu(), cpu(*xs[0]))
    if not cpu_err <= VERIFY_BAND * (1 + float(outs[0].abs().max())):
        fail(f"{name}: card and CPU disagree ({cpu_err:.3e})")
    print(f"  {name}: group {group}; {REQUESTS} requests, wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; launches "
          f"{launches[lib_name]} ({lib_name}); verify max_abs_err {err:.3e} "
          f"(output scale {scale:.3f}) within {VERIFY_BAND:.0e}; card vs "
          f"the port on the CPU {cpu_err:.3e}")
    run = program.lower(jit=False)
    env = program.make_env(*dev[2])
    return {"name": name, "shapes": shapes, "group": group,
            "compile_s": compile_s, "request_ms": walls,
            "launches": launches, "kernel_launches": launches[lib_name],
            "launches_per_request": per_request,
            "verify_max_abs_err": err, "verify_scale": scale,
            "verify_band": VERIFY_BAND, "cpu_max_abs_err": cpu_err,
            "profile": profile_device(lambda: [run(env) for _ in range(3)],
                                      calls=3)}


def mm_path() -> dict:
    """The blocked matmul through its public wrapper ops.mm (no pattern
    routes it) at the FFN's fc shape: four calls with the launch counters
    zeroed just before and read just after."""
    import torch
    from repro_torch.kernels.matmul import mm
    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    M, K, N = MM_SHAPE
    xs = [torch.randn(M, K, generator=g, device="cuda") / math.sqrt(K)
          for _ in range(REQUESTS)]
    w = torch.randn(K, N, generator=g, device="cuda")
    mm(xs[0], w)
    torch.cuda.synchronize()
    zero_counts()
    walls, outs = [], []
    for x in xs:
        t = time.perf_counter()
        outs.append(mm(x, w))
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    launches = {k: lib.launches for k, lib in all_libraries().items()}
    if launches["matmul"] != REQUESTS or sum(launches.values()) != REQUESTS:
        fail(f"ops.mm: expected {REQUESTS} matmul launches, got {launches}")
    err = max(max_err(y, torch.matmul(x, w)) for x, y in zip(xs, outs))
    scale = max(float(torch.matmul(x, w).abs().max()) for x in xs)
    if not err <= MM_TOL["f32"] * (1 + scale):
        fail(f"ops.mm against torch.matmul: {err:.3e}")
    print(f"  ops.mm {M}x{K}x{N}: {REQUESTS} calls, wall "
          f"{', '.join(f'{t:.3f}' for t in walls)} ms; launches "
          f"{launches['matmul']}; against torch.matmul {err:.3e}")
    return {"request_ms": walls, "launches": launches,
            "max_abs_err_vs_torch": err}


def _mse(F, y, target):
    d = F.sub(y, target)
    return F.mean_all(F.mul(d, d))


def resnet18_loss_fn(x, target):
    """ResNet-18's MSE against a (N, 1000) target: the CNN train path."""
    from repro_torch.core import frontend as F
    from repro_torch.models.dataflow_models import resnet18_fn
    return _mse(F, resnet18_fn(x), target)


def rglru_loss_fn(a, gate, x, target):
    """rglru_block's MSE: differentiated with respect to its operands
    ``a`` and ``gate`` (it has no weights)."""
    from repro_torch.core import frontend as F
    from repro_torch.models.rglru import rglru_block_fn
    return _mse(F, rglru_block_fn(a, gate, x), target)


def ssd_loss_fn(states, decay, target):
    """ssd_block's MSE, with respect to ``states`` and ``decay``."""
    from repro_torch.core import frontend as F
    from repro_torch.models.ssm import ssd_block_fn
    return _mse(F, ssd_block_fn(states, decay), target)


def train_workloads() -> list:
    """(name, loss, specs, wrt, the forward's routed group or None, the
    library that must launch, its launches a step, a maker of seeded
    (parameters, inputs by name), whether to hold one step against the
    CPU) of each train path of the slice: ResNet-18 at N = 1 and 8, whose
    phases route nothing (its relu outputs are residuals, so no conv
    chain is exclusive), and the two recurrences, whose forward routes
    its scan and whose backward's scan gradient runs two more launches of
    the same kernel (h, then the reverse recurrence)."""
    import numpy as np

    from repro_torch.kernels.rglru.rglru import launches as rglru_launches
    from repro_torch.models.dataflow_models import random_inputs

    def resnet(N):
        def make(step, rng):
            env = random_inputs(step.source, seed=int(rng.integers(1 << 30)))
            params = {w: env[w] for w in step.param_names}
            return params, {"x": env["x"], "target": env["target"]}
        return (f"resnet18 N={N}", resnet18_loss_fn,
                [(N, 3, IMAGE, IMAGE), (N, 1000)], None, None, None, 0,
                make, N == 1)

    def rglru_make(step, rng):
        params = {"a": rng.uniform(0.5, 0.999, RGLRU_SHAPE),
                  "gate": rng.uniform(0.0, 1.0, RGLRU_SHAPE)}
        named = {k: rng.standard_normal(RGLRU_SHAPE) for k in ("x", "target")}
        return ({k: v.astype(np.float32) for k, v in params.items()},
                {k: v.astype(np.float32) for k, v in named.items()})

    nc, BH = SSD_SHAPE[:2]

    def ssd_make(step, rng):
        params = {"states": 0.1 * rng.standard_normal(SSD_SHAPE),
                  "decay": rng.uniform(0.5, 0.99, (nc, BH, 1, 1))}
        named = {"target": 0.1 * rng.standard_normal(SSD_SHAPE)}
        return ({k: v.astype(np.float32) for k, v in params.items()},
                {k: v.astype(np.float32) for k, v in named.items()})

    return [resnet(N) for N in CNN_BATCHES] + [
        ("rglru_block", rglru_loss_fn, [RGLRU_SHAPE] * 4, ("a", "gate"),
         RGLRU, "rglru", 3 * rglru_launches(), rglru_make, True),
        ("ssd_block", ssd_loss_fn, [SSD_SHAPE, (nc, BH, 1, 1), SSD_SHAPE],
         ("states", "decay"), SSD, "ssd", 3, ssd_make, True)]


def slice_train_path(seed, name, fn, specs, wrt, group, lib_name, per_step,
                     make, on_cpu) -> dict:
    """codo_torch.compile(fn, *specs, grad=True, wrt=wrt) under forced
    routing: the routed groups of each phase asserted; a warm step, then
    four steps with the launch counters zeroed just before and read just
    after (the path's kernel, its count a step, and no other); verify()
    on the card with each gradient held to its own scale; one step
    against the port on the CPU; one profiled step."""
    import numpy as np
    import torch

    import codo_torch
    t0 = time.perf_counter()
    step = codo_torch.compile(fn, *specs, grad=True, wrt=wrt)
    groups = {ph: [g.kernel for g in getattr(step, ph).lower().groups
                   if g.routes] for ph in PHASES}
    compile_s = time.perf_counter() - t0
    want = {"forward": [group] if group else [], "backward": [],
            "update": []}
    if groups != want:
        fail(f"{name} train step: expected routed groups {want}, got "
             f"{groups}")
    params, named = make(step, np.random.default_rng(seed))
    if len({v.tobytes() for v in params.values()}) != len(params):
        fail(f"{name}: parameters are not distinct")
    zero = {"m": {w: np.zeros_like(v) for w, v in params.items()},
            "v": {w: np.zeros_like(v) for w, v in params.items()},
            "step": np.zeros((), np.int32)}
    p, s = codo_torch.train_state_from_numpy(params, zero, step)
    # The inputs come from the layer before, on the card: placed there as
    # set-up, not copied in each step.
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in named.items()}
    p1, s1, m1 = step.step(p, s, **dev, jit=False)            # warm (allocator, libs)
    torch.cuda.synchronize()

    zero_counts()
    walls, metrics = [], []
    q, u = p1, s1
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        q, u, m = step.step(q, u, **dev, jit=False)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        metrics.append(m)
    launches = {k: lib.launches for k, lib in all_libraries().items()}
    entries = (dict(all_libraries()[lib_name].entry_launches) if lib_name
               else {})
    expected = {k: TRAIN_STEPS * per_step if k == lib_name else 0
                for k in launches}
    if launches != expected:
        fail(f"{name} train step: launches {launches}, expected {expected}")
    values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if not all(math.isfinite(v) for vs in values.values() for v in vs):
        fail(f"{name}: non-finite metrics {values}")
    if int(u["step"]) != 1 + TRAIN_STEPS:
        fail(f"{name}: step counter {int(u['step'])}")
    for w in step.param_names:
        if not bool(torch.isfinite(q[w]).all()) or bool((q[w] == p[w]).all()):
            fail(f"{name}: parameter {w} not finite or not updated")
    verify = step.verify(params=p, **dev, **TRAIN_BAND)
    rel = {w: scaled(f"{name} verify grad {w}", *verify[w], GRAD_TOL)
           for w in step.param_names}
    print(f"  {name}: groups {groups}; {TRAIN_STEPS} steps, wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; launches "
          f"{ {k: n for k, n in launches.items() if n} or 'none'}; loss "
          f"{values['loss'][0]:.6f} -> {values['loss'][-1]:.6f}; verify "
          f"within rtol {TRAIN_BAND['rtol']:.0e} / atol "
          f"{TRAIN_BAND['atol']:.0e}, each gradient within "
          f"{max(rel.values()):.2e} of its max (band {GRAD_TOL:.0e})")
    result = {"name": name, "specs": specs, "wrt": wrt, "groups": groups,
              "compile_s": compile_s, "step_ms": walls,
              "launches": launches,
              "kernel_launches": launches[lib_name] if lib_name else 0,
              "entry_launches": entries,
              "launches_per_step": per_step, "metrics": values,
              "verify_band": TRAIN_BAND, "verify": verify,
              "verify_grad_rel_err": rel, "grad_tol": GRAD_TOL}
    if on_cpu:
        result["cpu"] = train_card_vs_cpu(name, fn, specs, wrt, params, zero,
                                          named, (p1, s1, m1))
    result["profile"] = profile_device(lambda: step.step(q, u, **dev, jit=False))
    return result


def reload_path() -> dict:
    """gpt2_block at S=128 and its train step through export and
    codo_torch.load on the card: the program (weights in a .npz sidecar)
    answers four requests bit for bit as the exporting program does, with
    the same routed groups and launches; the train step (weights
    embedded) takes one step from the same state as the exporting step,
    loss and parameters within rtol 1e-6."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.models.dataflow_models import (gpt2_block_fn,
                                                    gpt2_block_loss_fn)
    S = SEQS[0]
    out_dir = ROOT / "build" / "artifacts"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 70)
    program = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    weights = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                        ).astype(np.float32) for b in program.graph.weights()}
    program.bind(**codo_torch.params_from_numpy(weights, program.graph,
                                                program.device))
    groups = [g.kernel for g in program.lower().groups if g.routes]
    t0 = time.perf_counter()
    path = out_dir / "gpt2_block.json"
    program.export(path, weights=True, sidecar=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = codo_torch.load(path)
    loaded_groups = [g.kernel for g in loaded.lower().groups if g.routes]
    load_s = time.perf_counter() - t0
    if loaded.device != program.device or loaded_groups != groups:
        fail(f"reload: groups {loaded_groups} on {loaded.device}, the "
             f"exporting program's {groups}")
    xs = [torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(
        np.float32), device="cuda") for _ in range(REQUESTS)]
    zero_counts()
    want = [program(x, jit=False) for x in xs]
    torch.cuda.synchronize()
    launches = {k: lib.launches for k, lib in all_libraries().items()}
    zero_counts()
    got = [loaded(x, jit=False) for x in xs]
    torch.cuda.synchronize()
    again = {k: lib.launches for k, lib in all_libraries().items()}
    if again != launches or not launches["flash"]:
        fail(f"reload: launches {again}, the exporting program's {launches}")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("reload: the loaded program's outputs differ from the "
             "exporting program's")

    step = codo_torch.compile(gpt2_block_loss_fn, (S, D_MODEL), (S, D_MODEL),
                              grad=True)
    params = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                       ).astype(np.float32) for b in step.source.weights()}
    zero = {"m": {w: np.zeros_like(v) for w, v in params.items()},
            "v": {w: np.zeros_like(v) for w, v in params.items()},
            "step": np.zeros((), np.int32)}
    p, s = codo_torch.train_state_from_numpy(params, zero, step)
    train_path_ = out_dir / "gpt2_block_loss.json"
    t0 = time.perf_counter()
    step.export(train_path_, weights=p)
    loaded_step = codo_torch.load(train_path_)
    train_reload_s = time.perf_counter() - t0
    lp = loaded_step.init_params()
    if sorted(lp) != sorted(p) or not all(torch.equal(lp[w], p[w])
                                          for w in p):
        fail("reload: the train step's carried weights differ")
    x, t = (torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(
        np.float32), device="cuda") for _ in range(2))
    a = step.step(p, s, x, t, jit=False)
    b = loaded_step.step(lp, loaded_step.init_opt_state(lp), x, t,
                         jit=False)
    torch.cuda.synchronize()
    loss_err = abs(float(a[2]["loss"]) - float(b[2]["loss"]))
    if not loss_err <= 1e-6 * abs(float(a[2]["loss"])):
        fail(f"reload: loss {float(b[2]['loss'])} against "
             f"{float(a[2]['loss'])}")
    param_err = 0.0
    for w in step.param_names:
        param_err = max(param_err, max_err(b[0][w], a[0][w]))
        if not bool(torch.allclose(b[0][w], a[0][w], rtol=1e-6, atol=0.0)):
            fail(f"reload: parameter {w} after one step differs")
    sizes = {f.name: f.stat().st_size for f in sorted(out_dir.iterdir())}
    print(f"  gpt2_block S={S}: export {export_s:.2f} s, load + lower "
          f"{load_s:.2f} s, groups {loaded_groups}; {REQUESTS} requests bit "
          f"for bit the exporting program's, launches {again}; train step "
          f"export + load {train_reload_s:.2f} s, one step: loss "
          f"{loss_err:.1e}, parameters {param_err:.1e} (max abs); files "
          f"{sizes}")
    return {"S": S, "groups": loaded_groups, "export_s": export_s,
            "load_s": load_s, "launches": again,
            "train_reload_s": train_reload_s, "train_loss_err": loss_err,
            "train_param_max_abs_err": param_err, "bytes": sizes}


def fit_workloads() -> list:
    """(label, compile, repeats) of every path the script drives — the
    gpt2_block program at both S and batched as the serving phase serves
    it, its train step at both S, ResNet-18 at both N, VGG-16, the
    recurrence and attention-tail paths — then the three catalog CNNs new
    to the card; ``compile()`` builds the program or train step on the
    card."""
    import codo_torch
    from repro_torch.core.frontend import batch_graph, trace
    from repro_torch.models import dataflow_models as dm
    D = D_MODEL
    out = [(f"gpt2_block S={S}",
            lambda S=S: codo_torch.compile(dm.gpt2_block_fn, (S, D)),
            FIT_REPEATS) for S in SEQS]
    # The serving phase's batched program: SERVE_BATCH requests of
    # gpt2_block coalesced (frontend.batch_graph), as the runtime builds it.
    out.append((f"gpt2_block serving batch {SERVE_BATCH}",
                lambda: codo_torch.compile(batch_graph(
                    trace(dm.gpt2_block_fn, (SERVE_S, D), name="gpt2_block"),
                    SERVE_BATCH)), FIT_REPEATS))
    out += [(f"gpt2_block train S={S}",
             lambda S=S: codo_torch.compile(dm.gpt2_block_loss_fn, (S, D),
                                            (S, D), grad=True),
             FIT_REPEATS) for S in SEQS]
    out += [(f"resnet18 N={N}",
             lambda N=N: codo_torch.compile(dm.resnet18_fn,
                                            (N, 3, IMAGE, IMAGE)),
             FIT_REPEATS) for N in CNN_BATCHES]
    out.append(("vgg16 N=1", lambda: codo_torch.compile(
        dm.vgg16_fn, (1, 3, IMAGE, IMAGE)), FIT_REPEATS))
    for name, fn, shapes, group, *_ in slice_workloads():
        out.append((name, lambda fn=fn, shapes=shapes: codo_torch.compile(
            fn, *shapes), FIT_SCAN_REPEATS if group in (RGLRU, SSD)
            else FIT_REPEATS))
    out += [(f"{name} N=1", lambda name=name, shape=shape: codo_torch.compile(
        getattr(dm, f"{name}_fn"), shape), FIT_REPEATS)
        for name, shape in NEW_CNNS]
    return out


def first_run(label: str, program) -> dict:
    """A catalog CNN's first run on the card (under forced routing, so its
    chains run their kernels): fan-in-scaled seeded weights, one request,
    finite output, the lowered program against the oracle on the card
    with the error held relative to the output's scale, as the train and
    serving checks are: mobilenet's fan-in weights shrink its output to
    ~1e-4, so an absolute band of VERIFY_BAND could not fail there."""
    import torch

    import codo_torch
    from repro_torch.models.dataflow_models import random_inputs
    env = random_inputs(program.graph, seed=SEED + 90)
    weights = {k: v for k, v in env.items()
               if program.graph.buffers[k].kind == "weight"}
    program.bind(**codo_torch.params_from_numpy(weights, program.graph,
                                                program.device))
    x = env[program.input_names[0]]
    t = time.perf_counter()
    y = program(x, jit=False)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    if not bool(torch.isfinite(y).all()):
        fail(f"{label}: output not finite")
    env = program.make_env(x)
    got = program.lower(jit=False)(env)[program.output_names[0]]
    ref = program.source.execute(env)[program.output_names[0]]
    err, scale = max_err(got, ref), float(ref.abs().max())
    rel = scaled(f"{label} verify", err, scale, VERIFY_BAND)
    groups = [g.kernel for g in program.lower(jit=False).groups if g.routes]
    # Forced routing routes none of mobilenet's chains at 224, in either
    # package: its first conv has stride 2, its 3 x 3 convs are depthwise
    # and its 1 x 1 convs have no pad, so no stride-1 pad -> conv -> relu
    # chain matches.  No fault: nothing to route.
    note = "" if groups else ": no chain matches a pattern"
    print(f"  {label}: first run on the card, output {tuple(y.shape)}, "
          f"{len(groups)} routed groups (forced{note}), first request "
          f"{wall:.1f} ms; verify max_abs_err {err:.3e}, output scale "
          f"{scale:.4e}, ratio {rel:.2e} within {VERIFY_BAND:.0e}")
    return {"output_shape": list(y.shape), "routed_groups": groups,
            "first_request_ms": wall, "verify_max_abs_err": err,
            "verify_scale": scale, "verify_rel_err": rel}


def gate_plan(made):
    """The routed groups of a program (a train step's by phase) under the
    default gate — lowered afresh, as a program on the card would be."""
    from repro_torch.core.lowering import lower

    def routed(program):
        return [g.kernel for g in lower(program.compiled,
                                        device=program.device).groups
                if g.routes]

    forced = os.environ.pop("CODO_FORCE_PALLAS", None)
    try:
        if hasattr(made, "forward"):
            return {ph: routed(getattr(made, ph)) for ph in PHASES}
        return routed(made)
    finally:
        if forced is not None:
            os.environ["CODO_FORCE_PALLAS"] = forced


def routing_fit() -> dict:
    """Autotune every path into a private TuningDB — never the process
    default: its records beat CODO_FORCE_PALLAS in the routing gate, and
    later phases would stop launching kernels — and print each record;
    fit the "cuda" gate's efficiencies from them (calibrate_routing_params)
    beside the constants in use; then each path's plan under the default
    gate, asserted."""
    from repro_torch.core.costmodel import (DEFAULT_ROUTING_PARAMS,
                                            calibrate_routing_params)
    from repro_torch.core.tuning import TuningDB
    t0 = time.perf_counter()
    db = TuningDB()
    rows, plans, first, seconds = [], {}, {}, {}
    new = {f"{name} N=1" for name, _ in NEW_CNNS}
    for label, build, repeats in fit_workloads():
        t = time.perf_counter()
        made = build()
        if label in new:
            first[label] = first_run(label, made)
        for r in made.autotune(db=db, repeats=repeats, warmup=2, seed=SEED):
            rows.append({"workload": label, "graph": r.workload,
                         "kernel": r.pattern, "tasks": r.tasks,
                         "routed_ms": r.routed_ms, "generic_ms": r.generic_ms,
                         "speedup": r.speedup, "choice": r.choice,
                         "signature": r.signature})
            print(f"  {label}: {r.pattern:<20s} routed {r.routed_ms:.4f} ms, "
                  f"generic {r.generic_ms:.4f} ms ({r.speedup:.3f}x) -> "
                  f"{r.choice}")
        plan = gate_plan(made)
        plans[label] = plan
        seconds[label] = time.perf_counter() - t
        print(f"  {label}: default-gate plan {plan}")
        if plan != DEFAULT_GATE_PLANS.get(label):
            fail(f"{label}: the default gate routes {plan}, expected "
                 f"{DEFAULT_GATE_PLANS.get(label)}")
    fit = calibrate_routing_params({"backend": "cuda", "records": rows})
    have = DEFAULT_ROUTING_PARAMS["cuda"]
    print("  fitted efficiency (geomean of generic/routed, clamped 0.5-2.0) "
          "beside the constants in use:")
    for pat, eff in fit.efficiency:
        n = sum(1 for r in rows if r["kernel"] == pat)
        print(f"    {pat:<20s} {eff:.4f} from {n} records (constant "
              f"{have.eff(pat):.4f})")
    total = time.perf_counter() - t0
    print(f"  routing fit: {len(rows)} records in {total:.1f} s")
    return {"records": rows, "efficiency": dict(fit.efficiency),
            "constants": dict(have.efficiency), "default_gate_plans": plans,
            "first_runs": first, "seconds": seconds, "total_s": total}


def measure_serving_flash(record: dict) -> dict:
    """Flash at the batched program's shape, (8, 128, 1024) with kᵀ a
    view as the route hands it over: measure_flash, and two calls bit
    for bit the same."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 101)
    B, S = SERVE_BATCH, SERVE_S
    q = torch.randn(B, 1, S, D_MODEL, generator=g, device="cuda")
    k = torch.randn(B, 1, D_MODEL, S, generator=g,
                    device="cuda").transpose(-1, -2)
    v = torch.randn(B, 1, S, D_MODEL, generator=g, device="cuda")
    name = f"flash serving batch {B}x1x{S}x{D_MODEL} scale={C}"
    m = measure_flash(record, name, q, k, v, 20)
    kw = dict(causal=False, window=0, scale=C)
    same(record["checks"], name, flash_attention(q, k, v, **kw),
         flash_attention(q, k, v, **kw))
    print(f"  {name}: kernel {m['ms']:.4f} ms (device {m['device_ms']:.4f})"
          f"  plain {m['plain_ms']:.4f} ms  SDPA {m['library_ms']:.4f} ms  "
          f"{bound_text(m)}")
    return m


def _rel(got, want) -> float:
    """Largest difference relative to the answer's own scale."""
    return max_err(got, want) / float(want.float().abs().max())


def dispatch_parts(program, xs, y_name: str, jit: bool = False) -> dict:
    """One dispatch of ``program`` on the requests ``xs`` (stacked when
    there are several) taken apart on the host, median of five: the
    inputs to the card, the lowered program (eager, or captured with
    ``jit``) to its end, the answer to the host; and the profiled device
    time of one run."""
    import numpy as np
    import torch
    parts: dict = {"to_card_ms": [], "run_ms": [], "to_host_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        x = torch.stack([torch.as_tensor(x, device="cuda") for x in xs])
        x = x if len(xs) > 1 else x[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        env = program.make_env(x)
        y = program.lower(jit=jit)(env)[y_name]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        y.cpu()
        t3 = time.perf_counter()
        for key, a, b in (("to_card_ms", t0, t1), ("run_ms", t1, t2),
                          ("to_host_ms", t2, t3)):
            parts[key].append(1e3 * (b - a))
    out = {k: float(np.median(v)) for k, v in parts.items()}
    run = program.lower(jit=jit)
    out["profile"] = profile_device(lambda: run(env))
    out["device_ms"] = sum(r["device_us"] for r in out["profile"]) / 1e3
    print(f"    {len(xs)} request(s) in one dispatch: to the card "
          f"{out['to_card_ms']:.3f} ms, run {out['run_ms']:.3f} ms (device "
          f"{out['device_ms']:.3f}), to the host {out['to_host_ms']:.3f} ms")
    return out


def serving_path() -> dict:
    """The serving runtime on the card, under forced routing as every
    kernel path here (the fitted gate declines flash at every gpt2_block
    shape, the batched one included: the routing fit asserts that plan):
    gpt2_block at GPT-2 medium exported with distinct seeded weights and
    served from the artifact — one window of SERVE_BATCH requests as one
    batched dispatch (one compile miss, flash launched once for the whole
    batch), each answer against the same request served alone, and the
    dispatch's host and device time taken apart; SERVE_FREE requests
    free-running against as many served one at a time; ResNet-18, which
    cannot batch, per request; a hot-swap to a second generation under
    load; and a one-worker spawn pool against the inline runtime, bit for
    bit."""
    import tempfile

    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core.cache import CompileCache
    from repro_torch.kernels.flashattn.flashattn import flash_launches
    from repro_torch.kernels.streamfuse import CONV_LIBRARY as CONVLIB
    from repro_torch.models import dataflow_models as dm
    from repro_torch.serving import ServeConfig, ServingRuntime

    S, B = SERVE_S, SERVE_BATCH
    rng = np.random.default_rng(SEED + 100)

    def requests(n):
        return [rng.standard_normal((S, D_MODEL)).astype(np.float32)
                for _ in range(n)]

    def window(rt, model, xs):
        """xs placed in one batching window: (futures, answers)."""
        rt.pause()
        futs = [rt.submit(model, x=x) for x in xs]
        rt.resume()
        return futs, [f.result(timeout=600)[y_name] for f in futs]

    (ROOT / "build").mkdir(exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        gens, paths = [], []
        for gen in range(2):
            # cache=None: a design of its own, whose recorded routing no
            # earlier lowering of the same structure has written over.
            program = codo_torch.compile(dm.gpt2_block_fn, (S, D_MODEL),
                                         cache=None)
            weights = {b.name: (rng.standard_normal(b.shape)
                                / math.sqrt(b.shape[0])).astype(np.float32)
                       for b in program.graph.weights()}
            if len({w.tobytes() for w in weights.values()}) != len(weights):
                fail("serving: bound weights are not distinct")
            program.bind(**codo_torch.params_from_numpy(
                weights, program.graph, program.device))
            path = Path(tmp) / f"gpt2_block_gen{gen}.json"
            program.export(path, weights=True)
            gens.append(program)
            paths.append(str(path))
        y_name = gens[0].output_names[0]

        cache = CompileCache()
        cfg = ServeConfig(batch_window_ms=500, max_batch=B)
        # Requests served alone: a runtime that dispatches each at once.
        solo = ServingRuntime(ServeConfig(max_batch=1), cache=cache)
        solo.add_model("gpt2", paths[0])
        with solo, ServingRuntime(cfg, cache=cache) as rt:
            handle = rt.add_model("gpt2", paths[0])
            xs = requests(B)
            misses = cache.stats.misses
            zero_counts()
            t = time.perf_counter()
            futs, outs = window(rt, "gpt2", xs)
            first_ms = 1e3 * (time.perf_counter() - t)
            launches = {k: lib.launches for k, lib in all_libraries().items()}
            st = rt.stats
            if (st.batches, st.batched_requests) != (1, B):
                fail(f"serving: {st.batches} dispatches, "
                     f"{st.batched_requests} batched; expected 1 and {B}")
            if cache.stats.misses - misses != 1:
                fail(f"serving: {cache.stats.misses - misses} compile "
                     f"misses for one batched window, expected 1")
            plan = [g.kernel for g in handle.batched[B].lower().groups]
            want = flash_launches(S, S, B, D_MODEL)
            print(f"  batched window: {B} requests in one dispatch, "
                  f"{first_ms:.1f} ms (its compile included); plan {plan}; "
                  f"launches {launches}")
            if launches["flash"] != want or any(
                    n for k, n in launches.items() if k != "flash"):
                fail(f"serving: launches {launches}, expected flash {want} "
                     f"(one call for the whole batch) and nothing else")
            alone = [solo.submit("gpt2", x=x).result(timeout=600)[y_name]
                     for x in xs]
            rel = [_rel(b, a) for b, a in zip(outs, alone)]
            bitwise = [bool(torch.equal(b, a)) for b, a in zip(outs, alone)]
            print(f"  batched vs served alone, relative to each answer's "
                  f"scale: {', '.join(f'{r:.2e}' for r in rel)}; bit for "
                  f"bit: {sum(bitwise)} of {B}")
            if max(rel) > VERIFY_BAND:
                fail(f"serving: batched answers {max(rel):.3e} from "
                     f"sequential, above {VERIFY_BAND:.0e}")
            out["batched"] = {"plan": plan, "launches": launches,
                              "flash_launches": launches["flash"],
                              "first_window_ms": first_ms,
                              "rel_vs_alone": rel, "bit_identical": bitwise,
                              "compile_misses": 1,
                              "dispatch": dispatch_parts(
                                  handle.batched[B], xs, y_name),
                              "request": dispatch_parts(
                                  gens[0], xs[:1], y_name)}

            # Free-running arrival, then the same number one at a time.
            xs = requests(SERVE_FREE)
            t = time.perf_counter()
            futs = [rt.submit("gpt2", x=x) for x in xs]
            for f in futs:
                f.result(timeout=600)
            batched_s = time.perf_counter() - t
            lat = sorted(1e3 * (f.resolved - f.submitted) for f in futs)
            t = time.perf_counter()
            seq = []
            for x in xs:
                f = solo.submit("gpt2", x=x)
                f.result(timeout=600)
                seq.append(1e3 * (f.resolved - f.submitted))
            sequential_s = time.perf_counter() - t
            p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
            # Each dispatch of the free-running run, from the one before it
            # ended to its own end (the queue never ran dry in between).
            ends = [max(f.resolved for f in futs[i:i + B])
                    for i in range(0, SERVE_FREE, B)]
            gaps = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
            out["throughput"] = {
                "requests": SERVE_FREE, "batched_s": batched_s,
                "sequential_s": sequential_s,
                "batched_rps": SERVE_FREE / batched_s,
                "sequential_rps": SERVE_FREE / sequential_s,
                "p50_ms": p50, "p99_ms": p99,
                "sequential_p50_ms": float(np.percentile(seq, 50)),
                "sequential_p99_ms": float(np.percentile(seq, 99)),
                "dispatch_gaps_ms": gaps}
            print(f"  {SERVE_FREE} free-running requests: "
                  f"{SERVE_FREE / batched_s:.1f} req/s batched, p50 "
                  f"{p50:.2f} ms, p99 {p99:.2f} ms; one at a time "
                  f"{SERVE_FREE / sequential_s:.1f} req/s; a dispatch of "
                  f"{B} after the first: "
                  f"{', '.join(f'{g:.2f}' for g in gaps)} ms")

            # ResNet-18 cannot batch (pad2d, conv2d): per request.
            shape = (1, 3, IMAGE, IMAGE)
            cnn = codo_torch.compile(dm.resnet18_fn, shape)
            env = dm.random_inputs(cnn.graph, seed=SEED + 102)
            cnn.bind(**codo_torch.params_from_numpy(
                {k: v for k, v in env.items()
                 if cnn.graph.buffers[k].kind == "weight"},
                cnn.graph, cnn.device))
            blockers = rt.add_model("resnet18", cnn).blockers
            routed = sum(1 for g in cnn.lower().groups for r in g.routes
                         if r.kernel == "streamfuse.conv")
            before = rt.stats.fallback_requests
            zero_counts()
            rt.pause()
            cfuts = [rt.submit("resnet18",
                               x=rng.standard_normal(shape).astype(np.float32))
                     for _ in range(REQUESTS)]
            rt.resume()
            cnn_outs = [f.result(timeout=600)[cnn.output_names[0]]
                        for f in cfuts]
            conv_calls = CONVLIB.entry_launches["codo_pad_conv_relu"]
            fallback = rt.stats.fallback_requests - before
            print(f"  resnet18 {shape}: {fallback} requests per request "
                  f"({blockers[0]}); conv kernel calls "
                  f"{conv_calls} = {routed} routed chains x {REQUESTS}")
            if fallback != REQUESTS or conv_calls != routed * REQUESTS:
                fail(f"serving: resnet18 fallback {fallback}, conv calls "
                     f"{conv_calls}; expected {REQUESTS} and "
                     f"{routed} x {REQUESTS}")
            if not all(bool(torch.isfinite(y).all()) for y in cnn_outs):
                fail("serving: resnet18 answers not finite")
            out["fallback"] = {"requests": fallback, "routed_chains": routed,
                               "conv_calls": conv_calls}

            # Hot-swap to the second generation with requests in flight.
            xs = requests(3 * B)
            refs = [[g(x, jit=False).cpu() for x in xs] for g in gens]
            done0 = rt.stats.completed
            rt.pause()
            futs = [rt.submit("gpt2", x=x) for x in xs]
            rt.resume()
            t = time.perf_counter()
            rt.swap("gpt2", paths[1])
            swap_ms = 1e3 * (time.perf_counter() - t)
            after = requests(B)
            afuts, aouts = window(rt, "gpt2", after)
            answers = [f.result(timeout=600)[y_name] for f in futs]
            which = []
            for i, y in enumerate(answers):
                hits = [g for g in range(2)
                        if _rel(y, refs[g][i]) <= VERIFY_BAND]
                if len(hits) != 1:
                    fail(f"serving: swap answer {i} matches generations "
                         f"{hits}")
                which.append(hits[0])
            for y, x in zip(aouts, after):
                if _rel(y, gens[1](x, jit=False).cpu()) > VERIFY_BAND:
                    fail("serving: a request after swap() returned did "
                         "not get the new generation")
            lost = 4 * B - (rt.stats.completed - done0)
            print(f"  hot-swap under load: swap {swap_ms:.1f} ms; "
                  f"{which.count(0)} in-flight answers from the old "
                  f"generation, {which.count(1)} from the new; {B} after "
                  f"the swap all new; lost {lost}, failed {rt.stats.failed}")
            if lost or rt.stats.failed:
                fail(f"serving: {lost} requests lost, {rt.stats.failed} "
                     f"failed in the swap")
            out["swap"] = {"swap_ms": swap_ms, "old": which.count(0),
                           "new": which.count(1), "after": B, "lost": lost}

            # The same window of four through the inline runtime (now the
            # second generation), for the pool to match.
            xs4 = requests(4)
            _f, inline = window(rt, "gpt2", xs4)
            out["stats"] = rt.stats.snapshot()

        pool_cfg = ServeConfig(batch_window_ms=500, max_batch=4, workers=1)
        with ServingRuntime(pool_cfg, cache=CompileCache()) as pool:
            pool.add_model("gpt2", paths[1])
            futs, pooled = window(pool, "gpt2", xs4)
            first_ms = 1e3 * (futs[0].resolved - futs[0].submitted)
            futs2, again = window(pool, "gpt2", xs4)
            warm_ms = 1e3 * (futs2[0].resolved - futs2[0].submitted)
            if pool.stats.batched_requests != 8:
                fail(f"serving: the pool coalesced "
                     f"{pool.stats.batched_requests} of 8 requests")
        same_bits = all(bool(torch.equal(a, b))
                        for a, b in zip(pooled + again, inline + inline))
        print(f"  worker pool (1 spawned worker): first window {first_ms:.1f} "
              f"ms (spawn, CUDA context, load, compile), next "
              f"{warm_ms:.1f} ms; answers equal the inline runtime's bit for "
              f"bit: {same_bits}")
        if not same_bits:
            fail("serving: the worker's answers differ from the inline "
                 "runtime's")
        out["pool"] = {"first_window_ms": first_ms, "next_window_ms": warm_ms,
                       "bit_identical": same_bits}
    return out


@contextlib.contextmanager
def eager_programs():
    """Within, every ``CompiledProgram`` lowers eagerly (``jit=False``)
    whatever its caller asks: the serving phase measures the runtime on
    eager programs, as its earlier numbers were taken, and the capture
    phase the runtime as it now runs (``jit=True``) beside them.  A
    spawned worker process does not see this."""
    from repro_torch.api import CompiledProgram
    lower = CompiledProgram.lower
    CompiledProgram.lower = lambda self, jit=True: lower(self, jit=False)
    try:
        yield
    finally:
        CompiledProgram.lower = lower


def counts() -> dict:
    return {k: lib.launches for k, lib in all_libraries().items()}


def wall_and_device(fn, iters: int = REQUESTS) -> dict:
    """``iters`` calls of ``fn`` (host clock, each ending in synchronize)
    after a warm call, and the profiled device time of one more: the
    device's idle share is 1 - device / median wall."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    rows = device_rows(fn)
    dev = sum(r["device_us"] for r in rows) / 1e3 if rows else None
    wall = float(np.median(walls))
    return {"wall_ms": walls, "median_ms": wall, "device_ms": dev,
            "idle": None if dev is None else 1.0 - dev / wall,
            "profile": rows[:8]}


def wall_text(m: dict) -> str:
    dev = ("device not measured" if m["device_ms"] is None else
           f"device {m['device_ms']:.3f} ms, idle {100 * m['idle']:.0f} %")
    return (f"{m['median_ms']:.3f} ms [{min(m['wall_ms']):.3f}-"
            f"{max(m['wall_ms']):.3f}] ({dev})")


def both_ways(label: str, eager, captured, iters: int = REQUESTS) -> dict:
    """:func:`wall_and_device` of the eager and the captured form, eager
    first."""
    out = {"eager": wall_and_device(eager, iters),
           "captured": wall_and_device(captured, iters)}
    print(f"    {label}: eager {wall_text(out['eager'])}; captured "
          f"{wall_text(out['captured'])}")
    return out


def seeded_weights(graph, rng) -> dict:
    """Distinct seeded weights over the square root of their fan-in."""
    import numpy as np
    weights = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                        ).astype(np.float32) for b in graph.weights()}
    if len({w.tobytes() for w in weights.values()}) != len(weights):
        fail(f"{graph.name}: bound weights are not distinct")
    return weights


def capture_forward(S: int) -> dict:
    """gpt2_block at (S, 1024) lowered with jit=True against jit=False:
    the first call (the eager warm-up's answer) and two replays bit for
    bit the eager answers, the first replay's answer untouched by the
    second, launches per call equal, an in-place change to a bound weight
    seen by the next replay; walls and idle shares both ways."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core import capture
    from repro_torch.models.dataflow_models import gpt2_block_fn
    rng = np.random.default_rng(SEED + 200 + S)
    program = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    weights = {k: torch.as_tensor(v, device="cuda")
               for k, v in seeded_weights(program.graph, rng).items()}
    program.bind(**weights)
    xs = [torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(
        np.float32), device="cuda") for _ in range(2)]
    eager = [program(x, jit=False) for x in xs]
    captures = capture.CAPTURE_STATS["captures"]
    t = time.perf_counter()
    first = program(xs[0])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t)
    if capture.CAPTURE_STATS["captures"] != captures + 1:
        fail(f"capture S={S}: the first jit=True call captured no graph")
    y0 = program(xs[0])
    keep = y0.clone()
    y1 = program(xs[1])
    torch.cuda.synchronize()
    checks = {"first call": torch.equal(first, eager[0]),
              "replay 1": torch.equal(y0, eager[0]),
              "replay 2": torch.equal(y1, eager[1]),
              "replay 1 kept": torch.equal(y0, keep)}
    zero_counts()
    for _ in range(REQUESTS):
        program(xs[0], jit=False)
    torch.cuda.synchronize()
    eager_launches = counts()
    zero_counts()
    for _ in range(REQUESTS):
        program(xs[0])
    torch.cuda.synchronize()
    captured_launches = counts()
    # The bound weight itself, changed in place.
    w = program.make_env(xs[0])[program.graph.weights()[0].name]
    w.mul_(2.0)                                 # exact, and undone below
    changed = program(xs[0])
    checks["weight change seen"] = (torch.equal(changed,
                                                program(xs[0], jit=False))
                                    and not torch.equal(changed, eager[0]))
    w.mul_(0.5)
    checks["weight restored"] = torch.equal(program(xs[0]), eager[0])
    print(f"  gpt2_block S={S}: first captured call {first_ms:.1f} ms "
          f"(eager warm-up + capture); bit for bit: "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; launches per {REQUESTS} calls eager {eager_launches}, "
          f"captured {captured_launches}")
    if not all(checks.values()):
        fail(f"capture S={S}: {checks}")
    if captured_launches != eager_launches or not eager_launches["flash"]:
        fail(f"capture S={S}: launches {captured_launches} against eager "
             f"{eager_launches}")
    walls = both_ways(f"gpt2_block S={S} request (inputs on the card)",
                      lambda: program(xs[0], jit=False),
                      lambda: program(xs[0]))
    return {"S": S, "first_call_ms": first_ms, "checks": checks,
            "launches": {"eager": eager_launches,
                         "captured": captured_launches},
            "walls": walls}


def _tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return bool(torch.equal(a, b))


def capture_train() -> dict:
    """gpt2_block_loss's train step at S=128: three AdamW steps with
    jit=True bit for bit three with jit=False from the same state (loss,
    gradients, parameters, moments), launches per step equal; walls and
    idle shares both ways."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.models.dataflow_models import gpt2_block_loss_fn
    S = SEQS[0]
    rng = np.random.default_rng(SEED + 210)
    step = codo_torch.compile(gpt2_block_loss_fn, (S, D_MODEL), (S, D_MODEL),
                              grad=True)
    params = seeded_weights(step.source, rng)
    zero = {"m": {w: np.zeros_like(v) for w, v in params.items()},
            "v": {w: np.zeros_like(v) for w, v in params.items()},
            "step": np.zeros((), np.int32)}
    x, t = (torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(
        np.float32), device="cuda") for _ in range(2))
    runs, launches = {}, {}
    for jit in (False, True):
        p, s = codo_torch.train_state_from_numpy(params, zero, step)
        trail = [step.value_and_grad(x, t, params=p, jit=jit)]
        for i in range(3):
            if i == 2:
                zero_counts()
            p, s, m = step.step(p, s, x, t, jit=jit)
            trail.append((p, s, m))
        torch.cuda.synchronize()
        launches[jit] = counts()
        runs[jit] = trail
    same = {"loss and gradients": _tree_equal(
                {"loss": runs[True][0][0], **runs[True][0][1]},
                {"loss": runs[False][0][0], **runs[False][0][1]})}
    for i in range(1, 4):
        (pa, sa, ma), (pb, sb, mb) = runs[True][i], runs[False][i]
        same[f"step {i}"] = (_tree_equal(pa, pb)
                             and _tree_equal(sa["m"], sb["m"])
                             and _tree_equal(sa["v"], sb["v"])
                             and _tree_equal(ma, mb))
    print(f"  gpt2_block train step S={S}: captured against eager, bit for "
          f"bit: " + ", ".join(f"{k} {v}" for k, v in same.items())
          + f"; launches of a step eager {launches[False]}, captured "
          f"{launches[True]}")
    if not all(same.values()):
        fail(f"capture train: {same}")
    if launches[True] != launches[False] or not launches[False]["mmgrad"]:
        fail(f"capture train: launches {launches}")
    p, s, _m = runs[True][3]
    walls = both_ways(f"gpt2_block train step S={S}",
                      lambda: step.step(p, s, x, t, jit=False),
                      lambda: step.step(p, s, x, t))
    return {"S": S, "bit_identical": same,
            "launches": {"eager": launches[False],
                         "captured": launches[True]}, "walls": walls}


def capture_rglru_train() -> dict:
    """rglru_block's train step at (2, 2048, 4096): its three phases
    (three rglru_scan launches a step) become three graphs.
    One step and the gradients with jit=True against jit=False, each
    tensor within GRAD_TOL of its scale, the bit-for-bit count reported;
    the capture's host seconds and memory; walls both ways."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core import capture
    (name, fn, specs, wrt, _g, _lib, _per, make, _cpu) = [
        w for w in train_workloads() if w[0] == "rglru_block"][0]
    step = codo_torch.compile(fn, *specs, grad=True, wrt=wrt)
    params, named = make(step, np.random.default_rng(SEED + 220))
    zero = {"m": {w: np.zeros_like(v) for w, v in params.items()},
            "v": {w: np.zeros_like(v) for w, v in params.items()},
            "step": np.zeros((), np.int32)}
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in named.items()}
    p, s = codo_torch.train_state_from_numpy(params, zero, step)
    want = step.step(p, s, **dev, jit=False)
    torch.cuda.synchronize()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    cap0 = dict(capture.CAPTURE_STATS)
    t0 = time.perf_counter()
    step.step(p, s, **dev)                      # warm-up, then capture
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    graphs = capture.CAPTURE_STATS["captures"] - cap0["captures"]
    capture_s = capture.CAPTURE_STATS["capture_s"] - cap0["capture_s"]
    got = step.step(p, s, **dev)
    (gp, gs, gm), (wp, ws, wm) = got, want
    rel, bits = {}, {}
    pairs = {**{f"p {w}": (gp[w], wp[w]) for w in step.param_names},
             **{f"m {w}": (gs["m"][w], ws["m"][w]) for w in step.param_names},
             **{f"v {w}": (gs["v"][w], ws["v"][w]) for w in step.param_names},
             "loss": (gm["loss"], wm["loss"])}
    for k, (a, b) in pairs.items():
        bits[k] = bool(torch.equal(a, b))
        rel[k] = scaled(f"capture rglru {k}", max_err(a, b),
                        float(b.float().abs().max()), GRAD_TOL)
    print(f"  rglru_block train step {RGLRU_SHAPE}: {graphs} graphs "
          f"captured in {capture_s:.2f} s of host time (first step "
          f"{first_s:.2f} s with its eager warm-up), memory +"
          f"{(mem1[0] - mem0[0]) / 2**20:.1f} MiB allocated, +"
          f"{(mem1[1] - mem0[1]) / 2**20:.1f} MiB reserved; captured "
          f"against eager within {max(rel.values()):.2e} of each tensor's "
          f"scale (band {GRAD_TOL:.0e}), bit for bit {sum(bits.values())} "
          f"of {len(bits)}")
    walls = both_ways(f"rglru_block train step {RGLRU_SHAPE}",
                      lambda: step.step(p, s, **dev, jit=False),
                      lambda: step.step(p, s, **dev), iters=3)
    return {"graphs": graphs, "capture_s": capture_s,
            "first_step_s": first_s,
            "memory_allocated_mib": (mem1[0] - mem0[0]) / 2**20,
            "memory_reserved_mib": (mem1[1] - mem0[1]) / 2**20,
            "rel_err": rel, "bit_identical": bits, "walls": walls}


def capture_resnet() -> dict:
    """ResNet-18 at N=1 (five conv chains routed): a replayed request
    against the eager one within VERIFY_BAND of the output's scale, the
    bit-for-bit result reported; walls both ways."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.models import dataflow_models as dm
    shape = (1, 3, IMAGE, IMAGE)
    program = codo_torch.compile(dm.resnet18_fn, shape)
    env = dm.random_inputs(program.graph, seed=SEED + 230)
    program.bind(**codo_torch.params_from_numpy(
        {k: v for k, v in env.items()
         if program.graph.buffers[k].kind == "weight"},
        program.graph, program.device))
    x = torch.as_tensor(env["x"], device="cuda")
    want = program(x, jit=False)
    program(x)
    got = program(x)
    torch.cuda.synchronize()
    bit = bool(torch.equal(got, want))
    rel = scaled("capture resnet18", max_err(got, want),
                 float(want.abs().max()), VERIFY_BAND)
    print(f"  resnet18 N=1: replay against eager {rel:.2e} of the output's "
          f"scale (band {VERIFY_BAND:.0e}), bit for bit {bit}")
    walls = both_ways("resnet18 N=1 request (input on the card)",
                      lambda: program(x, jit=False), lambda: program(x))
    return {"rel_err": rel, "bit_identical": bit, "walls": walls}


def capture_serving(eager: dict) -> dict:
    """The serving runtime as it runs now (programs lowered with jit=True,
    the batched one captured per batch size): gpt2_block at (128, 1024)
    from an artifact, a window of eight as one dispatch (its answers bit
    for bit the same batched program run eagerly, the kernels launched
    once a dispatch), a second window replayed, one dispatch taken apart,
    SERVE_FREE requests free-running against as many one at a time,
    beside the eager runtime's numbers from the serving phase, and a
    hot-swap to a second generation under load (none lost)."""
    import tempfile

    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core.cache import CompileCache
    from repro_torch.kernels.flashattn.flashattn import flash_launches
    from repro_torch.models import dataflow_models as dm
    from repro_torch.serving import ServeConfig, ServingRuntime
    S, B = SERVE_S, SERVE_BATCH
    rng = np.random.default_rng(SEED + 240)
    gens = []
    for _ in range(2):
        program = codo_torch.compile(dm.gpt2_block_fn, (S, D_MODEL),
                                     cache=None)
        program.bind(**codo_torch.params_from_numpy(
            seeded_weights(program.graph, rng), program.graph,
            program.device))
        gens.append(program)
    y_name = gens[0].output_names[0]

    def requests(n):
        return [rng.standard_normal((S, D_MODEL)).astype(np.float32)
                for _ in range(n)]

    out: dict = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        paths = [str(Path(tmp) / f"gpt2_block_gen{i}.json") for i in range(2)]
        for program, path in zip(gens, paths):
            program.export(path, weights=True)
        path = paths[0]
        cache = CompileCache()
        solo = ServingRuntime(ServeConfig(max_batch=1), cache=cache)
        solo.add_model("gpt2", path)
        cfg = ServeConfig(batch_window_ms=500, max_batch=B)
        with solo, ServingRuntime(cfg, cache=cache) as rt:
            handle = rt.add_model("gpt2", path)
            windows = []
            for _ in range(2):
                xs = requests(B)
                zero_counts()
                rt.pause()
                futs = [rt.submit("gpt2", x=x) for x in xs]
                t = time.perf_counter()
                rt.resume()
                answers = [f.result(timeout=600)[y_name] for f in futs]
                ms = 1e3 * (time.perf_counter() - t)
                launches = counts()
                bp = handle.batched[B]
                stacked = torch.stack([torch.as_tensor(x, device="cuda")
                                       for x in xs])
                ref = bp(stacked, jit=False).cpu()
                windows.append({"ms": ms, "launches": launches,
                                "bit_identical": all(
                                    bool(torch.equal(a, ref[i]))
                                    for i, a in enumerate(answers))})
            want = flash_launches(S, S, B, D_MODEL)
            print(f"  serving (jit=True): two windows of {B}: "
                  + "; ".join(f"{w['ms']:.1f} ms, flash launches "
                              f"{w['launches']['flash']}, bit for bit the "
                              f"eager batched program {w['bit_identical']}"
                              for w in windows))
            for w in windows:
                if not w["bit_identical"] or w["launches"]["flash"] != want:
                    fail(f"capture serving: window {w}, flash expected "
                         f"{want}")
            out["windows"] = windows
            out["dispatch"] = dispatch_parts(handle.batched[B], requests(B),
                                             y_name, jit=True)
            xs = requests(SERVE_FREE)
            t = time.perf_counter()
            futs = [rt.submit("gpt2", x=x) for x in xs]
            for f in futs:
                f.result(timeout=600)
            batched_s = time.perf_counter() - t
            lat = [1e3 * (f.resolved - f.submitted) for f in futs]
            t = time.perf_counter()
            for x in xs:
                solo.submit("gpt2", x=x).result(timeout=600)
            sequential_s = time.perf_counter() - t
            # A hot-swap under load: the new generation is loaded, lowered
            # and captured on the caller's thread while the dispatch thread
            # replays the old one's graphs.
            xs = requests(3 * B)
            refs = [[g(x, jit=False).cpu() for x in xs] for g in gens]
            done0 = rt.stats.completed
            rt.pause()
            futs = [rt.submit("gpt2", x=x) for x in xs]
            rt.resume()
            t = time.perf_counter()
            rt.swap("gpt2", paths[1])
            swap_ms = 1e3 * (time.perf_counter() - t)
            answers = [f.result(timeout=600)[y_name] for f in futs]
            which = []
            for i, y in enumerate(answers):
                hits = [g for g in range(2)
                        if _rel(y, refs[g][i]) <= VERIFY_BAND]
                if len(hits) != 1:
                    fail(f"capture serving: swap answer {i} matches "
                         f"generations {hits}")
                which.append(hits[0])
            after = requests(1)[0]
            if _rel(rt.submit("gpt2", x=after).result(timeout=600)[y_name],
                    gens[1](after, jit=False).cpu()) > VERIFY_BAND:
                fail("capture serving: a request after swap() did not get "
                     "the new generation")
            lost = 3 * B + 1 - (rt.stats.completed - done0)
            if lost or rt.stats.failed:
                fail(f"capture serving: {lost} lost, {rt.stats.failed} "
                     f"failed in the swap")
            out["swap"] = {"swap_ms": swap_ms, "old": which.count(0),
                           "new": which.count(1), "lost": lost}
            print(f"  hot-swap under load (jit=True): swap {swap_ms:.1f} ms; "
                  f"{which.count(0)} in-flight answers from the old "
                  f"generation, {which.count(1)} from the new; lost 0")
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    out["throughput"] = {"batched_rps": SERVE_FREE / batched_s,
                         "sequential_rps": SERVE_FREE / sequential_s,
                         "p50_ms": p50, "p99_ms": p99}
    e = eager["throughput"]
    print(f"  {SERVE_FREE} free-running requests: captured "
          f"{SERVE_FREE / batched_s:.1f} req/s, p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms, one at a time {SERVE_FREE / sequential_s:.1f} "
          f"req/s; eager runtime (serving phase) {e['batched_rps']:.1f} "
          f"req/s, p50 {e['p50_ms']:.2f} ms, p99 {e['p99_ms']:.2f} ms, one "
          f"at a time {e['sequential_rps']:.1f} req/s")
    return out


def capture_path(serving: dict) -> dict:
    """The captured step runner (jit=True) against eager (jit=False) on
    every kind of path: the gpt2_block forward at both S, its train step,
    rglru_block's train step, ResNet-18, and the serving runtime.  Starts
    from an empty lowering memo, so every graph of the phase is captured
    in it (its counts and the capture's time and memory are the
    phase's)."""
    from repro_torch.core import capture
    from repro_torch.core.lowering import clear_lower_cache
    clear_lower_cache()
    t0 = time.perf_counter()
    out = {"forward": {str(S): capture_forward(S) for S in SEQS},
           "train": capture_train(),
           "rglru_train": capture_rglru_train(),
           "resnet18": capture_resnet(),
           "serving": capture_serving(serving)}
    out["stats"] = dict(capture.CAPTURE_STATS)
    out["seconds"] = time.perf_counter() - t0
    print(f"  capture phase: {out['stats']['captures']} graphs captured in "
          f"{out['stats']['capture_s']:.2f} s, {out['stats']['replays']} "
          f"replays; {out['seconds']:.1f} s in all")
    return out


def compiler_phase() -> dict:
    """The batch driver on the card: codo_opt_batch of gpt2_block and the
    gpt2-medium arch block at seq 128 (opt5, spawned workers), the grid's
    cells printed, each design lowered with jit=True on the card and its
    answer (a replay) held against the un-optimized oracle relative to
    the output's scale."""
    import torch

    from repro_torch.core.compiler import (ablation_jobs, batch_workloads,
                                           codo_opt_batch, format_batch_grid,
                                           verify_violation_free)
    from repro_torch.core.lowering import lower, oracle_outputs
    from repro_torch.models.dataflow_models import random_inputs
    wl = batch_workloads(seq=SERVE_S)
    names = ("gpt2_block", "gpt2-medium")
    t0 = time.perf_counter()
    results = codo_opt_batch(ablation_jobs({k: wl[k] for k in names},
                                           presets=["opt5"]),
                             cache=None, max_workers=2, executor="process")
    batch_s = time.perf_counter() - t0
    print(format_batch_grid(results))
    out = {"batch_s": batch_s, "cells": {}}
    for r in results:
        if not r.ok:
            fail(f"batch: {r.config}/{r.preset}: {r.error}")
        problems = verify_violation_free(r.compiled)
        low = lower(r.compiled, jit=True, device="cuda")
        source = wl[r.config]()
        env = {k: torch.as_tensor(v, device="cuda")
               for k, v in random_inputs(source, seed=SEED + 250).items()}
        low(env)                                # eager warm-up, capture
        got = low(env)                          # a replay
        want = oracle_outputs(source, env)
        rel = max(scaled(f"batch {r.config} {k}", max_err(got[k], want[k]),
                         float(want[k].abs().max()), VERIFY_BAND)
                  for k in want)
        groups = [g.kernel for g in low.groups if g.routes]
        print(f"  {r.config}/{r.preset}: speedup {r.compiled.speedup:.1f}x, "
              f"{r.compiled.final.total_cycles:,.0f} modeled cycles, "
              f"violations {problems or 'none'}; routed {groups}; on the "
              f"card (jit=True) against the oracle {rel:.2e} of scale")
        if problems:
            fail(f"batch: {r.config} keeps violations {problems}")
        out["cells"][f"{r.config}/{r.preset}"] = {
            "speedup": r.compiled.speedup,
            "cycles": r.compiled.final.total_cycles, "groups": groups,
            "rel_err": rel}
    return out


# --------------------------------------------------------------------------
# the sharding phase: gpt2_block on a 4 x 2 mesh of positions on one card
# --------------------------------------------------------------------------

SHARD_MESH = ((4, 2), ("data", "model"))
SHARD_STRATEGIES = ("replicate", "dp", "tp", "dp_tp", "auto")
# The reference's bound on a sharded jit=True answer against the
# single-device one (tests/test_sharding.py, jit_max_abs_err < 5e-4).
SHARD_JIT_TOL = 5e-4
VIA_VARS = ("CODO_COLLECTIVE_RING_BYTES", "CODO_COLLECTIVE_RSAG_BYTES")
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 8, 128


@contextlib.contextmanager
def collective_thresholds(nbytes: int):
    """Both decomposition thresholds at ``nbytes`` for the plans made
    within: 0 forces the ring and rs_ag vias, a huge value the direct
    forms."""
    old = {k: os.environ.get(k) for k in VIA_VARS}
    for k in VIA_VARS:
        os.environ[k] = str(nbytes)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def held_against_plain(record: list, label: str):
    """Within, every call a routed step makes to fused_matmul_chain or
    flash_attention (the kernel launch, at the local shape its position
    gives it) also computes the plain version on the same operands, and
    the kernel's answer is held to it (TOL["f32_wide"]·(1 + scale)).
    Yields {(kernel, shape): [calls, max error, scale]}; one check line
    per kernel and shape goes to ``record``."""
    from repro_torch.kernels.flashattn import flash_attention_plain
    from repro_torch.kernels.flashattn import patterns as flash_routes
    from repro_torch.kernels.streamfuse import matmul_chain_plain
    from repro_torch.kernels.streamfuse import ops as chain_routes
    seen: dict = {}
    chain, flash = chain_routes.fused_matmul_chain, flash_routes.flash_attention

    def hold(kernel, shape, got, want):
        err = max_err(got, want)
        scale = float(want.float().abs().max())
        entry = seen.setdefault((kernel, shape), [0, 0.0, 0.0])
        entry[0] += 1
        entry[1], entry[2] = max(entry[1], err), max(entry[2], scale)
        if not err <= TOL["f32_wide"] * (1.0 + scale):
            fail(f"{label}: {kernel} at {shape} disagrees with its plain "
                 f"version ({err:.3e}, scale {scale:.3f})")

    def held_chain(a, w1, w2, *, ew=()):
        got = chain(a, w1, w2, ew=ew)
        hold("mmchain", (a.shape[0], a.shape[1], w1.shape[1], w2.shape[1]),
             got, matmul_chain_plain(a, w1, w2, ew=getattr(ew, "ew", ew)))
        return got

    def held_flash(q, k, v, **kw):
        got = flash(q, k, v, **kw)
        hold("flash", tuple(q.shape), got,
             flash_attention_plain(q, k, v, **kw))
        return got

    chain_routes.fused_matmul_chain = held_chain
    flash_routes.flash_attention = held_flash
    try:
        yield seen
    finally:
        chain_routes.fused_matmul_chain = chain
        flash_routes.flash_attention = flash
    for (kernel, shape), (n, err, scale) in sorted(seen.items()):
        record.append({"case": f"{label} {kernel} {shape}", "calls": n,
                       "max_abs_err": err, "max_abs_ref": scale,
                       "tol": TOL["f32_wide"], "ok": True})


def sharding_path(S: int, card: str, record: dict) -> dict:
    """gpt2_block at (S, 1024) on make_debug_mesh((4, 2)): eight positions
    on the card.  For each strategy: the plan and its digest, the routed
    and "sharded" chains, one request with every kernel launch held
    against its plain version at its local shape, REQUESTS requests with
    the launch counters zeroed just before and read just after,
    verify_sharding against the single-device program and the error
    relative to the output's scale, and walls and device times beside the
    single-device program's.  Then the ring and rs_ag vias forced: they
    verify and are bit for bit their direct forms."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core.lowering import lower, verify_sharding
    from repro_torch.distributed.partition import partition
    from repro_torch.kernels.flashattn.flashattn import flash_launches
    from repro_torch.kernels.streamfuse.chain import chain_launches
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.dataflow_models import gpt2_block_fn
    rng = np.random.default_rng(SEED + 300 + S)
    program = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    program.bind(**{k: torch.as_tensor(v, device="cuda") for k, v in
                    seeded_weights(program.graph, rng).items()})
    x = torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(np.float32),
                        device="cuda")
    env = program.make_env(x)
    mesh = make_debug_mesh(*SHARD_MESH)
    positions = mesh.size
    single_run = lower(program.compiled, jit=False, device="cuda")
    single = single_run(env)
    single_ms = wall_and_device(lambda: single_run(env))
    print(f"  S={S}: {mesh!r}; {card}; single-device request "
          f"{wall_text(single_ms)}")
    out = {"S": S, "single": single_ms, "strategies": {}}
    answers = {}
    for strategy in SHARD_STRATEGIES:
        plan = partition(program.compiled, mesh, strategy)
        run = lower(program.compiled, jit=False, sharding=plan, mesh=mesh)
        routed = [r.kernel for g in run.groups for r in g.routes]
        sharded = [r.kernel for g in run.groups for r in g.rejected
                   if r.decision == "sharded"]
        want_routed = (["flashattn.mha", "streamfuse.mmchain"]
                       if plan.strategy == "replicate"
                       else ["streamfuse.mmchain"])
        if routed != want_routed or sharded != [
                k for k in ("flashattn.mha",) if k not in routed]:
            fail(f"sharding S={S} {strategy}: routed {routed}, sharded "
                 f"{sharded}; expected {want_routed}")
        label = f"sharded S={S} {strategy}"
        with held_against_plain(record["checks"], label) as held:
            y = run(env)
        torch.cuda.synchronize()
        zero_counts()
        for _ in range(REQUESTS):
            run(env)
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
        chain_shapes = sorted(s for k, s in held if k == "mmchain")
        want = {"mmchain": REQUESTS * sum(
            chain_launches(*s) * held[("mmchain", s)][0]
            for s in chain_shapes)}
        if plan.strategy == "replicate":
            want["flash"] = REQUESTS * positions * flash_launches(
                S, S, 1, D_MODEL)
        if launches != want or sum(held[("mmchain", s)][0]
                                   for s in chain_shapes) != positions:
            fail(f"{label}: launches {launches}, expected {want} (one "
                 f"chain call a position)")
        verify_sharding(program.compiled, plan, env, mesh=mesh)
        rel = max(_rel(y[k], single[k]) for k in single)
        if not all(bool(torch.isfinite(v).all()) for v in y.values()):
            fail(f"{label}: non-finite output")
        timing = wall_and_device(lambda: run(env))
        kinds = sorted({(s.kind, s.via) for s in plan.steps})
        print(f"    {strategy:<9s} -> {plan.strategy:<9s} digest "
              f"{plan.digest()}, {len(plan.steps)} collectives {kinds}; "
              f"routed {routed}, sharded {sharded}; launches per "
              f"{REQUESTS} requests {launches}; chain local shapes "
              f"{chain_shapes} max err "
              f"{max(held[('mmchain', s)][1] for s in chain_shapes):.2e}; "
              f"verify_sharding ok, {rel:.2e} of scale; request "
              f"{wall_text(timing)}")
        answers[plan.strategy] = y
        out["strategies"][strategy] = {
            "resolved": plan.strategy, "digest": plan.digest(),
            "estimated_cycles": plan.estimated_cycles,
            "collectives": [list(k) for k in kinds],
            "routed": routed, "sharded": sharded, "launches": launches,
            "chain_shapes": [list(s) for s in chain_shapes],
            "held": {f"{k} {s}": v for (k, s), v in held.items()},
            "rel_err": rel, "request": timing}
    if not all(torch.equal(answers["replicate"][k], single[k])
               for k in single):
        fail(f"sharding S={S}: replicate is not bit for bit the "
             f"single-device program")
    # The vias: every collective direct, then the ring and rs_ag forced.
    vias = {}
    for name, nbytes in (("direct", 1 << 62), ("forced", 0)):
        with collective_thresholds(nbytes):
            plan = partition(program.compiled, mesh, "dp_tp")
        run = lower(program.compiled, jit=False, sharding=plan, mesh=mesh)
        verify_sharding(program.compiled, plan, env, mesh=mesh)
        vias[name] = (plan, run(env))
    forced_kinds = {(s.kind, s.via) for s in vias["forced"][0].steps}
    if not {("all_gather", "ring"), ("psum", "rs_ag")} <= forced_kinds or \
            {s.via for s in vias["direct"][0].steps} != {"direct"}:
        fail(f"sharding S={S}: vias {forced_kinds}")
    bits = all(torch.equal(vias["forced"][1][k], vias["direct"][1][k])
               for k in single)
    print(f"    dp_tp forced vias {sorted(forced_kinds)} (digest "
          f"{vias['forced'][0].digest()}): verify_sharding ok, bit for bit "
          f"the direct forms {bits}")
    if not bits:
        fail(f"sharding S={S}: the ring / rs_ag vias differ from direct")
    out["forced_vias"] = {"digest": vias["forced"][0].digest(),
                          "vias": sorted(forced_kinds),
                          "bit_identical_to_direct": bits}
    return out


def measure_chain_local(paths: dict, record: dict) -> dict:
    """The chain kernel at each local shape the sharded phase launched it
    at (the unsplit shape, timed in phase 3, left out): held against its
    plain version, timed beside it and mm -> gelu -> mm, with its bound
    and profiled device time."""
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                matmul_chain_plain)
    from repro_torch.kernels.streamfuse.chain import ChainTail
    g = torch.Generator(device="cuda").manual_seed(SEED + 310)
    gelu = ChainTail(GELU)
    out = {}
    for S, path in paths.items():
        for strategy, r in path["strategies"].items():
            for M, K, N1, N2 in r["chain_shapes"]:
                key = f"{M}x{K}x{N1}x{N2}"
                if (M, N1) == (S, 4 * D_MODEL):
                    continue
                if key in out:
                    out[key]["strategies"].append(f"{strategy} S={S}")
                    continue
                a = torch.randn(M, K, generator=g, device="cuda")
                w1 = torch.randn(K, N1, generator=g,
                                 device="cuda") / math.sqrt(K)
                w2 = torch.randn(N1, N2, generator=g,
                                 device="cuda") / math.sqrt(N1)
                err = check(record["checks"], f"mmchain local {key} gelu",
                            fused_matmul_chain(a, w1, w2, ew=gelu),
                            matmul_chain_plain(a, w1, w2, ew=GELU),
                            TOL["f32_wide"])
                iters = 20 if M * N1 <= 128 * 4096 else 5
                ms, plain = in_turns(
                    lambda: matmul_chain_plain(a, w1, w2, ew=GELU),
                    lambda: fused_matmul_chain(a, w1, w2, ew=gelu), iters)

                def library_chain():
                    h = torch.nn.functional.gelu(a @ w1, approximate="tanh")
                    return h @ w2

                library = time_ms(library_chain, iters)
                work = (2.0 * M * N1 * (K + N2),
                        4.0 * (M * K + K * N1 + N1 * N2 + M * N2))
                out[key] = dict(
                    shape=[M, K, N1, N2], strategies=[f"{strategy} S={S}"],
                    max_abs_err=err, ms=ms, plain_ms=plain,
                    library_ms=library, **tf32x3_bound(*work),
                    device_ms=device_ms(lambda: fused_matmul_chain(
                        a, w1, w2, ew=gelu), iters))
                m = out[key]
                print(f"  mmchain local {key:<20s} kernel {m['ms']:.4f} ms "
                      f"(device {m['device_ms']:.4f})  plain "
                      f"{m['plain_ms']:.4f} ms  mm->gelu->mm "
                      f"{m['library_ms']:.4f} ms  {bound_text(m)}")
    return out


def sharding_api(S: int) -> dict:
    """The API path on the debug mesh: codo_torch.compile(..., mesh=) ->
    verify; lower(jit=True) memoized, its captured answer bit for bit
    jit=False and within SHARD_JIT_TOL of the single-device jit=True
    answer; export -> load with equal digests; the loaded program placed
    by mesh_from_spec raises on one card, then shard onto the debug mesh
    with its recorded strategy: the same digest, and an answer bit for
    bit the exported program's."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.core import capture
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.dataflow_models import gpt2_block_fn
    rng = np.random.default_rng(SEED + 320)
    mesh = make_debug_mesh(*SHARD_MESH)
    sharded = codo_torch.compile(gpt2_block_fn, (S, D_MODEL), mesh=mesh)
    single = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    weights = {k: torch.as_tensor(v, device="cuda") for k, v in
               seeded_weights(sharded.graph, rng).items()}
    sharded.bind(**weights)
    single.bind(**weights)
    x = torch.as_tensor(rng.standard_normal((S, D_MODEL)).astype(np.float32),
                        device="cuda")
    sharded.verify(x)
    low = sharded.lower(jit=True)
    memoized = low is sharded.lower(jit=True)
    eager = sharded(x, jit=False)
    captures = capture.CAPTURE_STATS["captures"]
    first, replay = sharded(x), sharded(x)
    torch.cuda.synchronize()
    captured = capture.CAPTURE_STATS["captures"] - captures
    jit_err = max_err(replay, single(x))
    checks = {"lower memoized": memoized, "one graph captured": captured == 1,
              "first call bit for bit eager": torch.equal(first, eager),
              "replay bit for bit eager": torch.equal(replay, eager),
              f"within {SHARD_JIT_TOL:.0e} of single-device jit=True":
                  jit_err < SHARD_JIT_TOL}
    art_dir = ROOT / "build" / "artifacts"
    art_dir.mkdir(parents=True, exist_ok=True)
    path = art_dir / "gpt2_block_sharded.json"
    sharded.export(str(path), weights=True)
    loaded = codo_torch.load(str(path))
    checks["loaded digest equal"] = (loaded.sharding.digest()
                                     == sharded.sharding.digest())
    try:
        loaded(x, jit=False)
    except RuntimeError as e:
        placed = str(e)
    else:
        fail("sharding: a loaded 4x2 plan ran on one card without a mesh")
    loaded.shard(make_debug_mesh(*SHARD_MESH), loaded.sharding.strategy)
    checks["re-sharded digest equal"] = (loaded.sharding.digest()
                                         == sharded.sharding.digest())
    checks["re-sharded answer bit for bit"] = torch.equal(
        loaded(x, jit=False), eager)
    timing = {"eager": wall_and_device(lambda: sharded(x, jit=False)),
              "captured": wall_and_device(lambda: sharded(x)),
              "single captured": wall_and_device(lambda: single(x))}
    print(f"  compile(gpt2_block_fn, ({S}, {D_MODEL}), mesh=...): "
          f"{sharded.sharding.summary()}; digest "
          f"{sharded.sharding.digest()}; "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; jit=True against single-device jit=True {jit_err:.2e}")
    print(f"    loaded on one card without a mesh: {placed[:120]}")
    print("    request: " + "; ".join(f"{k} {wall_text(v)}"
                                      for k, v in timing.items()))
    if not all(checks.values()):
        fail(f"sharding api: {checks}")
    return {"strategy": sharded.sharding.strategy,
            "digest": sharded.sharding.digest(), "checks": checks,
            "jit_max_abs_err": jit_err, "placement_error": placed,
            "request": timing}


def pipeline_phase() -> dict:
    """pipeline_fn over four stages of tanh(x·w + b) at D=1024, eight
    microbatches of 128 rows, on a ("stage", 4) debug mesh on the card:
    bit for bit reference_serial."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import (PipelineSchedule, pipeline_fn,
                                           reference_serial)
    from repro_torch.launch.mesh import make_debug_mesh
    rng = np.random.default_rng(SEED + 330)
    params = {"w": torch.as_tensor((rng.standard_normal(
        (PIPE_STAGES, D_MODEL, D_MODEL)) / math.sqrt(D_MODEL)).astype(
        np.float32), device="cuda"),
        "b": torch.as_tensor((rng.standard_normal((PIPE_STAGES, D_MODEL))
                              * 0.1).astype(np.float32), device="cuda")}
    x = torch.as_tensor(rng.standard_normal(
        (PIPE_MICRO, PIPE_ROWS, D_MODEL)).astype(np.float32), device="cuda")

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = make_debug_mesh((PIPE_STAGES,), ("stage",))
    run = pipeline_fn([stage] * PIPE_STAGES, mesh)
    y = run(params, x)
    want = reference_serial([stage] * PIPE_STAGES, params, x)
    err = max_err(y, want)
    sched = PipelineSchedule(PIPE_STAGES, PIPE_MICRO)
    timing = {"pipeline": wall_and_device(lambda: run(params, x)),
              "serial": wall_and_device(lambda: reference_serial(
                  [stage] * PIPE_STAGES, params, x))}
    print(f"  pipeline_fn {PIPE_STAGES} stages x {PIPE_MICRO} microbatches "
          f"of ({PIPE_ROWS}, {D_MODEL}) on {mesh!r}: vs serial max err "
          f"{err:.2e}, bit for bit {torch.equal(y, want)}; ticks "
          f"{sched.ticks}, bubble {sched.bubble_fraction:.1%}; "
          + "; ".join(f"{k} {wall_text(v)}" for k, v in timing.items()))
    if not torch.equal(y, want) or not bool(torch.isfinite(y).all()):
        fail(f"pipeline: not bit for bit the serial run ({err:.3e})")
    return {"max_abs_err": err, "ticks": sched.ticks,
            "bubble": sched.bubble_fraction, "timing": timing}


def sharding_phase(card: str, record: dict) -> dict:
    """The sharding phase (see the module docstring): each strategy at
    both S, the chain at its local shapes, the API path, no fallback, and
    the pipeline."""
    import codo_torch
    from repro_torch.distributed.plan import MeshSpec
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models.dataflow_models import gpt2_block_loss_fn
    t0 = time.perf_counter()
    paths = {S: sharding_path(S, card, record) for S in SEQS}
    chain_local = measure_chain_local(paths, record)
    api = sharding_api(SEQS[0])
    spec = MeshSpec(tuple(zip(SHARD_MESH[1], SHARD_MESH[0])))
    try:
        mesh_from_spec(spec)
    except RuntimeError as e:
        no_cards = str(e)
    else:
        fail("sharding: mesh_from_spec placed a 4x2 mesh on one card")
    try:
        codo_torch.compile(gpt2_block_loss_fn, (SEQS[0], D_MODEL),
                           (SEQS[0], D_MODEL), grad=True, mesh=spec)
    except codo_torch.TraceError as e:
        no_grad = str(e)
    else:
        fail("sharding: grad=True with mesh= did not raise")
    print(f"  no fallback: mesh_from_spec(4x2) raised ({no_cards[:80]}...); "
          f"grad=True with mesh= raised TraceError ({no_grad})")
    pipe = pipeline_phase()
    seconds = time.perf_counter() - t0
    print(f"  sharding phase {seconds:.1f} s")
    return {"paths": {str(S): p for S, p in paths.items()},
            "chain_local": chain_local, "api": api,
            "no_fallback": {"mesh_from_spec": no_cards, "grad": no_grad},
            "pipeline": pipe, "seconds": seconds}


# --------------------------------------------------------------------------
# The LM phase: the port's LM serving stack (repro_torch.models,
# repro_torch.serving.generator, serve --arch) on the card.
# --------------------------------------------------------------------------

# (a) GPT-2 medium at full width and depth in float32: a seeded (2, 32)
# batch.  Card against CPU, and teacher-forced decode against forward,
# within LM_TOL of the output's scale: float32 sums in other orders
# (cuBLAS against MKL; a softmax over the cache's slots against one over
# the causal mask) read ~1e-6 of the scale.
LM_ARCH = "gpt2-medium"
LM_SHAPE = (2, 32)
LM_TOL = 1e-4
# (b) GPT-2 medium in its published bfloat16: the serving CLI's defaults
# (4 slots, cache 128), the captured decode step against eager over
# LM_CAPTURE_STEPS steps, and a (4, 128) prefill.
LM_SLOTS, LM_CACHE = 4, 128
LM_CAPTURE_STEPS = 16
LM_PREFILL = (4, 128)
LM_WALLS = 16
# (c) every catalog arch at smoke(): forward and LM_SMOKE_STEPS decode
# steps, card against CPU, then the captured serve step against eager.
LM_SMOKE_STEPS = 3
# (d) the two recurrent archs at full width, one block-pattern group deep,
# float32: a (1, LM_WIDE_SEQ) prefill against teacher-forced decode, and
# each scan launch at the model's shape against its plain version.
LM_WIDE = ("mamba2-780m", "recurrentgemma-9b")
LM_WIDE_SEQ = 512


def _tree_to(tree, device):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _tree_paths(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def _scan_blocks(cfg) -> dict:
    """The forward's expected launches: one rglru_scan a RG-LRU block,
    one ssd_chunk_scan an SSM block."""
    n_groups, leftover = divmod(cfg.n_layers, len(cfg.block_pattern))
    kinds = list(cfg.block_pattern) * n_groups + list(
        cfg.block_pattern[:leftover])
    return {"rglru": kinds.count("rglru"), "ssd": kinds.count("ssm")}


def _held_launches(name: str, expected: dict) -> dict:
    """The launch counters after a forward: ``expected``'s and no other
    kernel's."""
    got = {k: v for k, v in counts().items() if v}
    want = {k: v for k, v in expected.items() if v}
    if got != want:
        fail(f"{name}: kernel launches {got}, expected {want}")
    return got


def _scaled_pair(record: list, name: str, got, want) -> float:
    """``got`` against ``want`` (either device) relative to ``want``'s
    scale, within LM_TOL; returns that relative error."""
    check_scaled(record, name, got.detach().float().cpu(),
                 want.detach().float().cpu(), LM_TOL)
    return record[-1]["rel_err"]


def _caches_close(record: list, name: str, got: dict, want: dict) -> None:
    """Every leaf of two decode caches within LM_TOL of its own scale;
    ``pos`` exactly."""
    import torch
    g, w = _tree_paths(got), _tree_paths(want)
    if g.keys() != w.keys():
        fail(f"{name}: cache paths differ")
    for path in w:
        a, b = g[path].cpu(), w[path].cpu()
        if path == "/pos" or not bool(b.abs().max() > 0):
            if not torch.equal(a, b):
                fail(f"{name}: cache {path} differs")
            continue
        _scaled_pair(record, f"{name} cache {path}", a, b)


def lm_gpt2_f32(record: list) -> dict:
    """(a) GPT-2 medium, full width and depth, float32: prefill / forward
    on the card against the port on the CPU, then teacher-forced
    decode_step for every position against forward on the card."""
    import dataclasses

    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    B, S = LM_SHAPE
    t0 = time.perf_counter()
    p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                          device="cpu")
    params = _tree_to(p_cpu, "cuda")
    b_cpu = M.make_batch(cfg, batch=B, seq=S, kind="prefill", seed=SEED,
                         device="cpu")
    batch = _tree_to(b_cpu, "cuda")
    zero_counts()
    logits = M.forward(params, batch, cfg)
    torch.cuda.synchronize()
    _held_launches("gpt2-medium forward", {})
    want = M.forward(p_cpu, b_cpu, cfg)
    out = {"params": M.param_count(params), "shape": [B, S],
           "logits": list(logits.shape)}
    out["forward_rel"] = _scaled_pair(
        record, "gpt2-medium f32 forward card vs CPU", logits, want)
    out["prefill_rel"] = _scaled_pair(
        record, "gpt2-medium f32 prefill card vs CPU",
        M.prefill(params, batch, cfg), want[:, -1])
    cache = M.init_cache(cfg, B, S, device="cuda")
    steps = []
    for t in range(S):
        step_logits, cache = M.decode_step(
            params, batch["tokens"][:, t].contiguous(), cache, cfg)
        steps.append(step_logits)
    out["decode_rel"] = _scaled_pair(
        record, "gpt2-medium f32 decode vs forward (card)",
        torch.stack(steps, dim=1), logits)
    if int(cache["pos"]) != S:
        fail(f"gpt2-medium decode: pos {int(cache['pos'])} after {S} steps")
    out["seconds"] = time.perf_counter() - t0
    return out


def lm_gpt2_bf16(record: list) -> dict:
    """(b) GPT-2 medium in bfloat16: ``serve --arch gpt2-medium`` with
    the CLI's defaults; the captured decode step bit for bit eager
    decode_step over LM_CAPTURE_STEPS steps (logits and every cache leaf);
    the decode step's wall both ways with device time and idle share; a
    (4, 128) prefill wall."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.core import capture
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving import cli
    from repro_torch.serving.generator import ServeStep
    out: dict = {}
    text = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["--arch", LM_ARCH])
    out["serve_s"] = time.perf_counter() - t0
    lines = text.getvalue().strip().splitlines()
    for line in lines:
        print(f"    serve: {line}")
    m = re.search(r"(\d+)/(\d+) finished; (\d+) decode steps, (\d+) tokens, "
                  r"([\d.]+) tok/s on (.+)$", lines[-1] if lines else "")
    if rc != 0 or not m or m.group(1) != m.group(2):
        fail(f"serve --arch {LM_ARCH}: exit {rc}, last line "
             f"{lines[-1] if lines else None!r}")
    out["serve"] = {"finished": int(m.group(1)), "steps": int(m.group(3)),
                    "tokens": int(m.group(4)), "tok_s": float(m.group(5)),
                    "device": m.group(6), "launches": counts()}

    cfg = get_config(LM_ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    eager_cache = M.init_cache(cfg, LM_SLOTS, LM_CACHE, device="cuda")
    capture_s0 = capture.CAPTURE_STATS["capture_s"]
    step = ServeStep(cfg, params,
                     M.init_cache(cfg, LM_SLOTS, LM_CACHE, device="cuda"),
                     LM_SLOTS)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (LM_CAPTURE_STEPS, LM_SLOTS)).astype(
        np.int32)
    for t in range(LM_CAPTURE_STEPS):
        want, eager_cache = M.decode_step(
            params, torch.from_numpy(toks[t]).cuda(), eager_cache, cfg)
        nxt, got = step(toks[t])
        if not (torch.equal(got, want) and torch.equal(
                nxt, torch.argmax(want, -1).to(torch.int32))):
            fail(f"gpt2-medium bf16: captured decode step {t} is not eager's "
                 f"bit for bit (max err {max_err(got, want):.3e})")
    same_cache = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(step.cache), tree_leaves(eager_cache)))
    if step.program.graphs() != 1 or not same_cache:
        fail("gpt2-medium bf16: no graph captured, or the captured cache is "
             "not eager's bit for bit")
    out["captured_bit_for_bit_steps"] = LM_CAPTURE_STEPS
    out["capture_s"] = capture.CAPTURE_STATS["capture_s"] - capture_s0
    record.append({"case": f"gpt2-medium bf16 captured decode x"
                           f"{LM_CAPTURE_STEPS}", "bit_identical": True,
                   "ok": True})
    print(f"  gpt2-medium bf16: captured decode step bit for bit eager over "
          f"{LM_CAPTURE_STEPS} steps (logits, next tokens, every cache "
          f"leaf); capture {out['capture_s']:.3f} s")

    tok = toks[0]
    timing_cache = M.init_cache(cfg, LM_SLOTS, LM_CACHE, device="cuda")

    def eager():
        logits, _ = M.decode_step(params, torch.from_numpy(tok).cuda(),
                                  timing_cache, cfg)
        return torch.argmax(logits, -1).to(torch.int32).cpu()

    def captured():
        return step(tok)[0].cpu()

    out["decode_step"] = both_ways(
        f"gpt2-medium bf16 decode step ({LM_SLOTS} slots, cache {LM_CACHE}, "
        f"next tokens to the host)", eager, captured, iters=LM_WALLS)
    cap = out["decode_step"]["captured"]["median_ms"]
    out["captured_tok_s"] = LM_SLOTS / cap * 1e3
    # A decode step reads every weight and the whole cache once: its byte
    # bound (the operations, 2 per weight and token, are far below).
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params) + tree_leaves(timing_cache))
    out["decode_bound_ms"], out["decode_bound_by"] = bound_ms(
        2.0 * LM_SLOTS * M.param_count(params), nbytes)
    print(f"    decode step bound {out['decode_bound_ms']:.4f} ms "
          f"({out['decode_bound_by']}: {nbytes / 1e9:.3f} GB read once)")
    B, S = LM_PREFILL
    batch = M.make_batch(cfg, batch=B, seq=S, kind="prefill", seed=SEED)
    out["prefill"] = wall_and_device(lambda: M.prefill(params, batch, cfg))
    print(f"    gpt2-medium bf16 prefill ({B}, {S}): "
          f"{wall_text(out['prefill'])}")
    print(f"    tokens a second: serve --arch {out['serve']['tok_s']:.1f} "
          f"(capture included); captured step {out['captured_tok_s']:.1f}")
    return out


def lm_smoke_archs(record: list) -> dict:
    """(c) Every catalog arch at its smoke() config: forward (the scan
    kernels' launches counted) and LM_SMOKE_STEPS decode steps, card
    against the port on the CPU, every cache leaf too; then the same
    steps through the captured serve step (``ServeStep``: its first call
    eager, the rest replays), bit for bit the eager steps on the card."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import CONFIGS, get_config
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving.generator import ServeStep
    out = {}
    for arch in sorted(CONFIGS):
        cfg = get_config(arch).smoke()
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
        params = _tree_to(p_cpu, "cuda")
        b_cpu = M.make_batch(cfg, batch=2, seq=64, kind="prefill",
                             seed=SEED, device="cpu")
        zero_counts()
        got = M.forward(params, _tree_to(b_cpu, "cuda"), cfg)
        torch.cuda.synchronize()
        launches = _held_launches(f"{arch} smoke forward", _scan_blocks(cfg))
        rel = {"forward": _scaled_pair(record, f"{arch} smoke forward",
                                       got, M.forward(p_cpu, b_cpu, cfg))}
        c_cpu = M.init_cache(cfg, 2, 64, device="cpu")
        c_card = M.init_cache(cfg, 2, 64, device="cuda")
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_SMOKE_STEPS, 2)).astype(np.int32)
        eager = []
        for t in range(LM_SMOKE_STEPS):
            want, c_cpu = M.decode_step(p_cpu, torch.from_numpy(toks[t]),
                                        c_cpu, cfg)
            got, c_card = M.decode_step(
                params, torch.from_numpy(toks[t]).cuda(), c_card, cfg)
            eager.append(got)
            rel[f"decode {t}"] = _scaled_pair(
                record, f"{arch} smoke decode {t}", got, want)
        _caches_close(record, f"{arch} smoke", c_card, c_cpu)
        step = ServeStep(cfg, params, M.init_cache(cfg, 2, 64, device="cuda"),
                         2)
        for t in range(LM_SMOKE_STEPS):
            nxt, got = step(toks[t])
            if not (torch.equal(got, eager[t]) and torch.equal(
                    nxt, torch.argmax(eager[t], -1).to(torch.int32))):
                fail(f"{arch} smoke: captured decode step {t} is not eager's "
                     f"bit for bit (max err {max_err(got, eager[t]):.3e})")
        if step.program.graphs() != 1 or not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(step.cache),
                                                  tree_leaves(c_card))):
            fail(f"{arch} smoke: no graph captured, or the captured cache is "
                 f"not eager's bit for bit")
        step.program.release()
        record.append({"case": f"{arch} smoke captured decode x"
                               f"{LM_SMOKE_STEPS}", "bit_identical": True,
                       "ok": True})
        out[arch] = {"rel": rel, "launches": launches,
                     "captured_bit_for_bit_steps": LM_SMOKE_STEPS}
        print(f"  {arch} smoke: forward, {LM_SMOKE_STEPS} decode steps card "
              f"vs CPU; captured serve step bit for bit eager")
    return out


def _measure_scan(name: str, kernel, plain, flops: float,
                  nbytes: float, err: float) -> dict:
    ms, plain_ms = in_turns(plain, kernel, 10)
    b, by = bound_ms(flops, nbytes)
    m = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
             bound_by=by, flops=flops, bytes=nbytes, library_ms=None,
             device_ms=device_ms(kernel, 10))
    print(f"  {name:<44s} kernel {ms:.4f} ms (device {m['device_ms']:.4f})"
          f"  plain {plain_ms:.4f}  library none  bound {b:.4f} ({by})")
    return m


def lm_wide(record: list) -> dict:
    """(d) mamba2-780m and recurrentgemma-9b at full width, one block-
    pattern group deep, float32: each scan launch of a (1, LM_WIDE_SEQ)
    prefill held at its shape against its plain version and timed; the
    counted prefill launching exactly one scan a recurrent block; its
    logits against teacher-forced decode_step on the card."""
    import dataclasses

    import torch
    import repro_torch.kernels.rglru.ops as rglru_ops
    import repro_torch.kernels.ssd.ops as ssd_ops
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunk_scan_plain
    out = {}
    for arch in LM_WIDE:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=len(base.block_pattern),
                                  dtype="float32")
        t0 = time.perf_counter()
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED))
        batch = M.make_batch(cfg, batch=1, seq=LM_WIDE_SEQ, kind="prefill",
                             seed=SEED)
        seen = []
        real = (rglru_ops.rglru, ssd_ops.ssd_states)

        def rec_rglru(a, b, **kw):
            seen.append(("rglru", a.clone(), b.clone(), kw))
            return real[0](a, b, **kw)

        def rec_ssd(states, decay, **kw):
            seen.append(("ssd", states.clone(), decay.clone(), kw))
            return real[1](states, decay, **kw)

        rglru_ops.rglru, ssd_ops.ssd_states = rec_rglru, rec_ssd
        try:
            M.forward(params, batch, cfg)
        finally:
            rglru_ops.rglru, ssd_ops.ssd_states = real
        zero_counts()
        logits = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        launches = _held_launches(f"{arch} prefill", _scan_blocks(cfg))
        if len(seen) != sum(launches.values()):
            fail(f"{arch}: {len(seen)} scan calls recorded, {launches} "
                 f"launched")
        kernels = {}
        for i, (kind, x, y, kw) in enumerate(seen):
            if kind == "rglru":
                ch = kw["chunk"]
                got = rglru_scan(x, y, chunk=ch)
                want = rglru_scan_plain(x, y, chunk=ch)
                name = f"{arch} rglru_scan {i} " + "x".join(map(str, x.shape))
                err = check(record, name, got, want, RGLRU_TOL)
                n = x.numel()
                m = _measure_scan(name, lambda: rglru_scan(x, y, chunk=ch),
                                  lambda: rglru_scan_plain(x, y, chunk=ch),
                                  2.0 * n, 4.0 * 3 * n, err)
            else:
                got, want = ssd_chunk_scan(x, y), ssd_chunk_scan_plain(x, y)
                name = f"{arch} ssd_chunk_scan {i} " + "x".join(
                    map(str, x.shape))
                err = check(record, name, got, want, SSD_TOL)
                n = x.numel()
                m = _measure_scan(name, lambda: ssd_chunk_scan(x, y),
                                  lambda: ssd_chunk_scan_plain(x, y),
                                  2.0 * n, 4.0 * (2 * n + y.numel()), err)
            m["kind"], m["shape"] = kind, list(x.shape)
            kernels[name] = m
        cache = M.init_cache(cfg, 1, LM_WIDE_SEQ, device="cuda")
        steps = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(LM_WIDE_SEQ):
            step_logits, cache = M.decode_step(
                params, batch["tokens"][:, t].contiguous(), cache, cfg)
            steps.append(step_logits)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t1) / LM_WIDE_SEQ
        rel = _scaled_pair(record, f"{arch} x{cfg.n_layers} f32 decode vs "
                                   f"prefill", torch.stack(steps, dim=1),
                           logits)
        out[arch] = {"layers": cfg.n_layers, "params": M.param_count(params),
                     "launches": launches, "kernels": kernels,
                     "decode_rel": rel, "eager_decode_step_ms": decode_ms,
                     "seconds": time.perf_counter() - t0}
        print(f"  {arch} x{cfg.n_layers} (d_model {cfg.d_model}): launches "
              f"{launches}, eager decode step {decode_ms:.3f} ms")
        del params, logits, steps, cache, seen
        torch.cuda.empty_cache()
    return out


def lm_phase(card: str, record: dict) -> dict:
    """The LM serving stack on the card: (a) GPT-2 medium in float32, (b)
    in bfloat16 through ``serve --arch`` and the captured decode step,
    (c) every catalog arch at smoke(), (d) the recurrent archs at full
    width."""
    print(f"card: {card}")
    checks = record["checks"]
    out = {}
    print(f"  (a) {LM_ARCH} float32, full width and depth, {LM_SHAPE}:")
    out["gpt2_f32"] = lm_gpt2_f32(checks)
    print(f"  (b) {LM_ARCH} bfloat16: serve --arch, the captured decode "
          f"step, walls:")
    out["gpt2_bf16"] = lm_gpt2_bf16(checks)
    print("  (c) every catalog arch at smoke(), card against CPU, captured "
          "against eager:")
    out["smoke"] = lm_smoke_archs(checks)
    print(f"  (d) {', '.join(LM_WIDE)} at full width, one group deep, "
          f"float32, (1, {LM_WIDE_SEQ}):")
    out["wide"] = lm_wide(checks)
    return out


# --------------------------------------------------------------------------
# The train phase: LM training on the card (repro_torch.training)
# --------------------------------------------------------------------------

# (a) The scans' backwards at full width: recurrentgemma-9b's recurrence
# (1, 2048, 4096); mamba2-780m's chunk states at (2, 2048): eight 256-step
# chunks over 2 x 48 heads of (64, 128).
TRAIN_RGLRU = (1, 2048, 4096)
TRAIN_SSD = (8, 96, 64, 128)
# (a) ssd_chunk_scan's forward and reverse kernels at the LM path's shapes
# (nc, BH, P, N): the ssd_block route; the mamba2-780m trainer's (2, 2048)
# batch; a 4 x 2 mesh unit (a data block's 2 sequences x a model position's
# 24 heads); a (1, 512) prefill.  L2-cold: SSD_FLUSH_BYTES written before
# each call (the L2 holds 50 MB, the 8 x 96 operands 25 MB each).
SSD_LM_SHAPES = [(16, 96, 64, 128), (8, 96, 64, 128), (8, 48, 64, 128),
                 (2, 48, 64, 128)]
SSD_FLUSH_BYTES = 100 * 2**20
# The mamba2-780m step walls (ms; NVIDIA H100 80GB HBM3, 700.00 W) while
# ssd_chunk_scan's backward was the forward kernel on flipped operands with
# the flips, products and sum around it: printed beside this run's walls,
# read by no check (the scans are ~1-2 % of a step).
COMPOSED_BACKWARD_WALLS_MS = {"mamba2-780m": 560.874,
                              "mamba2-780m 4x2": 2341.300}
# (b) Float32 at full width, one block-pattern group deep, a (1, 512)
# SyntheticLM batch: loss_fn's value and every gradient, card against CPU.
TRAIN_WIDE = {"mamba2-780m": 1, "recurrentgemma-9b": 3}
TRAIN_WIDE_BATCH = (1, 512)
# (c) The trainer at full width (published bfloat16 parameters, float32
# moments, remat on): mamba2-780m at full depth, and recurrentgemma-9b
# three layers deep (its 9B parameters' AdamW state, ~144 GB, do not fit
# the card's 80).
TRAINER_STEPS = 6
TRAINERS = {"mamba2-780m": ["--arch", "mamba2-780m", "--batch", "2",
                            "--seq", "2048"],
            "recurrentgemma-9b x3": ["--arch", "recurrentgemma-9b",
                                     "--layers", "3", "--batch", "1",
                                     "--seq", "2048"]}
# (d) Captured against eager: three steps of mamba2-780m one group deep.
TRAIN_CAPTURE_STEPS = 3
TRAIN_CAPTURE_BATCH = (2, 2048)
# (e) The restart: a failure injected after step 3 with a checkpoint every
# two steps (exit 42), then --resume to step 6.
RESTART_ARGS = ["--arch", "mamba2-780m", "--layers", "1", "--batch", "2",
                "--seq", "2048", "--steps", "6", "--ckpt-every", "2"]
RESTART_FAIL_AT = 3
# (f) --compiled: gpt2_block's loss at (128, 1024), four steps.
COMPILED_ARGS = ["--compiled", "--seq", "128", "--d-model", str(D_MODEL),
                 "--steps", str(TRAIN_STEPS)]


@contextlib.contextmanager
def plain_scans():
    """Within this context the scans' helpers call the plain versions in
    the kernels' place: the plain form of each backward (rglru's forward
    scan on reversed operands, ssd's reverse loop)."""
    import importlib
    rg = importlib.import_module("repro_torch.kernels.rglru.rglru")
    sd = importlib.import_module("repro_torch.kernels.ssd.ssd")
    real = (rg.rglru_scan, sd.ssd_chunk_scan, sd.ssd_chunk_scan_backward)
    (rg.rglru_scan, sd.ssd_chunk_scan,
     sd.ssd_chunk_scan_backward) = (rg.rglru_scan_plain,
                                    sd.ssd_chunk_scan_plain,
                                    sd.ssd_chunk_scan_backward_plain)
    try:
        yield
    finally:
        rg.rglru_scan, sd.ssd_chunk_scan, sd.ssd_chunk_scan_backward = real


def _scan_entry(name, kernel, plain, flops, nbytes, err) -> dict:
    ms, plain_ms = in_turns(plain, kernel, 10)
    b, by = bound_ms(flops, nbytes)
    m = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
             bound_by=by, flops=flops, bytes=nbytes, library_ms=None,
             device_ms=device_ms(kernel, 10))
    print(f"  {name:<48s} {ms:.4f} ms (device {m['device_ms']:.4f})  plain "
          f"{plain_ms:.4f}  library none  bound {b:.4f} ({by})")
    return m


def scan_autograd(kind: str, shape: tuple, g, record: list) -> dict:
    """One scan (``"rglru"`` at (B, S, D) or ``"ssd"`` at (nc, BH, P, N))
    through its autograd Function: one forward launch and one backward
    launch (ssd's: its reverse kernel), the output and both gradients
    against autograd through the plain version, within TOL["f32"] of each
    tensor's scale; the forward and the backward helper timed beside the
    plain forms and their byte bounds."""
    import importlib

    import torch
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.rglru import chunk_length
    from repro_torch.kernels.ssd.ops import ssd_states
    rg = importlib.import_module("repro_torch.kernels.rglru.rglru")
    sd = importlib.import_module("repro_torch.kernels.ssd.ssd")
    if kind == "rglru":
        ch = chunk_length(*shape)
        a = gates(shape, g, 0.5, 0.999).requires_grad_()
        b = torch.randn(shape, generator=g, device="cuda").requires_grad_()
        ins, cot = (a, b), torch.randn(shape, generator=g, device="cuda")
        fn = "rglru_scan"

        def diff(x, y):
            return rglru(x, y, chunk=ch)

        def plain(x, y):
            return rg.rglru_scan_plain(x, y, chunk=ch)
    else:
        # the states and cotangents at the scale of a chunk's states
        st = (0.1 * torch.randn(shape, generator=g, device="cuda")
              ).requires_grad_()
        dec = gates((shape[0], shape[1], 1, 1), g, 0.5, 0.99
                    ).requires_grad_()
        ins, cot = (st, dec), 0.1 * torch.randn(shape, generator=g,
                                                device="cuda")
        fn, diff, plain = "ssd_chunk_scan", ssd_states, sd.ssd_chunk_scan_plain
    text = "x".join(map(str, shape))
    zero_counts()
    got = diff(*ins)
    grads = torch.autograd.grad(got, ins, cot)
    torch.cuda.synchronize()
    _held_launches(f"{fn} forward and backward", {kind: 2})
    if kind == "ssd" and dict(sd.LIBRARY.entry_launches) != {
            "codo_ssd_chunk_scan": 1, "codo_ssd_chunk_scan_backward": 1}:
        fail(f"{fn}: expected one forward and one backward kernel launch, "
             f"got {dict(sd.LIBRARY.entry_launches)}")
    want = plain(*ins)
    want_grads = torch.autograd.grad(want, ins, cot)
    err = check_scaled(record, f"{fn} {text} autograd forward",
                       got.detach(), want.detach(), TOL["f32"])
    errs = [check_scaled(record, f"{fn} {text} grad {i}", gi, wi, TOL["f32"])
            for i, (gi, wi) in enumerate(zip(grads, want_grads))]
    x, y = (t.detach() for t in ins)
    h = got.detach()
    n = x.numel()
    if kind == "rglru":
        fwd = (lambda: rg.rglru_scan(x, y, chunk=ch),
               lambda: rg.rglru_scan_plain(x, y, chunk=ch))
        bwd = lambda: rg.rglru_scan_backward(cot, x, h, chunk=ch)
        f_bytes, b_bytes, b_flops = 4.0 * 3 * n, 4.0 * 5 * n, 3.0 * n
    else:
        fwd = (lambda: sd.ssd_chunk_scan(x, y),
               lambda: sd.ssd_chunk_scan_plain(x, y))
        bwd = lambda: sd.ssd_chunk_scan_backward(cot, y, h)
        f_bytes = 4.0 * (2 * n + y.numel())
        b_bytes, b_flops = 4.0 * (3 * n + 2 * y.numel()), 4.0 * n

    def bwd_plain(bwd=bwd):
        with plain_scans():
            return bwd()

    forward = _scan_entry(f"{fn} forward {text}", fwd[0], fwd[1], 2.0 * n,
                          f_bytes, err)
    backward = _scan_entry(f"{fn}_backward {text}", bwd, bwd_plain, b_flops,
                           b_bytes, max(errs))
    return {"shape": list(x.shape), "forward": forward,
            "backward": backward, "grad_errs": errs}


def train_scans(record: list) -> dict:
    """(a) Each scan through its autograd Function at full width
    (:func:`scan_autograd`): ``rglru_scan`` at TRAIN_RGLRU and
    ``ssd_chunk_scan`` at TRAIN_SSD."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SEED + 300)
    return {"rglru": scan_autograd("rglru", TRAIN_RGLRU, g, record),
            "ssd": scan_autograd("ssd", TRAIN_SSD, g, record)}


def l2_cold_ms(fn, iters: int = 10) -> tuple[float, float]:
    """(event ms, device ms) of one call of ``fn`` with SSD_FLUSH_BYTES
    written before it, so its operands come from device memory.  Each
    call's events bracket it alone, with the device held back
    (``torch.cuda._sleep``) until the host has queued it, so host time does
    not count; the device time is the profiler's over the calls, the
    flushes' fill kernels left out."""
    import torch
    flush = torch.empty(SSD_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(300_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    event = sum(a.elapsed_time(b) for a, b in events) / iters

    def run():
        for _ in range(iters):
            flush.zero_()
            fn()

    dev = sum(r["device_us"] for r in device_rows(run)
              if "FillFunctor" not in r["name"]) / iters / 1e3
    del flush
    return event, dev


def _held_exact(record: list, name: str, got, want, tol: float) -> float:
    """:func:`check_scaled`, or bit for bit where the plain version is all
    zero (ddecay over two chunks: h_0 = 0 and μ_nc = 0)."""
    import torch
    if bool(want.float().abs().max() > 0):
        return check_scaled(record, name, got, want, tol)
    ok = bool(torch.equal(got, want))
    record.append({"case": name, "bit_identical": ok, "ok": ok})
    print(f"  {name:<48s} all zero as the plain version: {ok}")
    if not ok:
        fail(f"{name}: the plain version is all zero, the kernel's is not")
    return 0.0


def ssd_shapes(record: list) -> dict:
    """(a) ssd_chunk_scan's forward and reverse kernels at SSD_LM_SHAPES:
    each held against its plain version (SSD_TOL; TOL["f32"] of each
    output's scale) and twice bit for bit, then timed L2-warm (calls back
    to back in turns with the plain version: CUDA events a call, and the
    profiled device time) and L2-cold
    (:func:`l2_cold_ms`), beside their byte bounds and the backward as it
    was composed before it had a kernel of its own — the forward kernel on
    flipped operands, flipped back, μ·h summed in float32 — as a
    yardstick."""
    import torch
    from repro_torch.kernels.ssd import ssd as sd
    g = torch.Generator(device="cuda").manual_seed(SEED + 301)
    out = {}
    for shape in SSD_LM_SHAPES:
        st, dec = ssd_operands(*shape, g)
        cot = 0.1 * torch.randn(shape, generator=g, device="cuda")
        text = "x".join(map(str, shape))
        h = sd.ssd_chunk_scan(st, dec)
        errs = {"forward": check(record, f"ssd_chunk_scan {text}", h,
                                 sd.ssd_chunk_scan_plain(st, dec), SSD_TOL)}
        got = sd.ssd_chunk_scan_backward(cot, dec, h)
        want = sd.ssd_chunk_scan_backward_plain(cot, dec, h)
        errs["backward"] = max(
            _held_exact(record, f"ssd_chunk_scan_backward {text} {part}", a,
                        b, TOL["f32"])
            for part, a, b in zip(("dstates", "ddecay"), got, want))
        again = sd.ssd_chunk_scan_backward(cot, dec, h)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"ssd_chunk_scan_backward {text}: two calls differ")

        def composed():
            mu = sd.ssd_chunk_scan(cot.flip(0), dec.flip(0)).flip(0)
            return mu, (mu * h).sum(dim=(-2, -1), keepdim=True)

        n, m = st.numel(), dec.numel()
        cases = {
            "forward": (lambda: sd.ssd_chunk_scan(st, dec),
                        lambda: sd.ssd_chunk_scan_plain(st, dec), 2.0 * n,
                        4.0 * (2 * n + m)),
            "backward": (lambda: sd.ssd_chunk_scan_backward(cot, dec, h),
                         lambda: sd.ssd_chunk_scan_backward_plain(cot, dec,
                                                                  h),
                         4.0 * n, 4.0 * (3 * n + 2 * m)),
            "composed backward": (composed, None, 4.0 * n,
                                  4.0 * (3 * n + 2 * m))}
        out[text] = {}
        for kind, (fn, plain, flops, nbytes) in cases.items():
            b, by = bound_ms(flops, nbytes)
            warm, plain_ms = (in_turns(plain, fn, 10) if plain else
                              (time_ms(fn, 10), None))
            warm_dev = device_ms(fn, 10)
            cold, cold_dev = l2_cold_ms(fn)
            out[text][kind] = dict(
                ms=warm, device_ms=warm_dev, cold_ms=cold,
                cold_device_ms=cold_dev, plain_ms=plain_ms, library_ms=None,
                bound_ms=b, bound_by=by, flops=flops, bytes=nbytes,
                max_abs_err=errs.get(kind, errs["backward"]))
            print(f"  ssd {kind:<17s} {text:<15s} L2-warm {warm:.4f} ms "
                  f"(device {warm_dev:.4f})  L2-cold {cold:.4f} (device "
                  f"{cold_dev:.4f})  bound {b:.4f} ({by})")
    return out


def train_wide(record: list) -> dict:
    """(b) mamba2-780m (one layer) and recurrentgemma-9b (rglru, rglru,
    attn) at full width in float32: loss_fn's value and every gradient
    leaf of a seeded (1, 512) SyntheticLM batch, card against CPU within
    GRAD_TOL of each leaf's largest value, three scan launches a recurrent
    block (forward, remat, backward), every leaf of the recurrent branch
    nonzero; then one adamw_update card against CPU, each update p1 - p0
    within UPDATE_TOL in norm."""
    import dataclasses

    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import value_and_grad
    out = {}
    B, S = TRAIN_WIDE_BATCH
    for arch, layers in TRAIN_WIDE.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        p_cpu = M.init_params(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
        params = _tree_to(p_cpu, "cuda")
        batch = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B,
                                            seed=SEED)).batch(0)
        b_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}

        def loss_of(p, b):
            return tf.loss_fn(p, b, cfg)

        zero_counts()
        loss, grads = value_and_grad(loss_of, params, _tree_to(b_cpu, "cuda"))
        torch.cuda.synchronize()
        blocks = _scan_blocks(cfg)
        launches = _held_launches(f"{arch} x{layers} loss and gradients",
                                  {k: 3 * n for k, n in blocks.items()})
        loss_c, grads_c = value_and_grad(loss_of, p_cpu, b_cpu)
        rel = {"loss": scaled(f"{arch} loss", abs(float(loss) - float(loss_c)),
                              abs(float(loss_c)), GRAD_TOL)}
        got, want = _tree_paths(grads), _tree_paths(grads_c)
        for path in want:
            rel[path] = scaled(f"{arch} grad {path}",
                               max_err(got[path].cpu(), want[path]),
                               float(want[path].abs().max()), GRAD_TOL)
        branch = [p for p in got if "/rec/" in p or "/ssm/" in p]
        zeros = [p for p in branch if not bool(got[p].abs().max() > 0)]
        if not branch or zeros:
            fail(f"{arch}: recurrent-branch gradients zero on the card: "
                 f"{zeros or 'no branch leaves'}")
        st_c = opt.adamw_init(params)
        st = opt.adamw_init(p_cpu)
        p1_c, _, _ = opt.adamw_update(grads, st_c, params, opt.OptConfig())
        p1, _, _ = opt.adamw_update(grads_c, st, p_cpu, opt.OptConfig())
        upd = {}
        for path, w0 in _tree_paths(p_cpu).items():
            d_card = _tree_paths(p1_c)[path].cpu() - _tree_paths(params)[
                path].cpu()
            d_cpu = _tree_paths(p1)[path] - w0
            upd[path] = float((d_card - d_cpu).norm() / d_cpu.norm())
            if not upd[path] <= UPDATE_TOL:
                fail(f"{arch}: adamw update of {path} differs by "
                     f"{upd[path]:.2e} in norm (band {UPDATE_TOL:.0e})")
        worst = max((v, k) for k, v in rel.items())
        record.append({"case": f"{arch} x{layers} f32 gradients card vs CPU",
                       "rel_err": worst[0], "tol": GRAD_TOL, "ok": True})
        out[arch] = {"layers": layers, "params": M.param_count(params),
                     "loss": float(loss), "loss_cpu": float(loss_c),
                     "launches": launches, "grad_rel": rel,
                     "branch_leaves": len(branch), "update_rel": upd,
                     "seconds": time.perf_counter() - t0}
        print(f"  {arch} x{layers} f32 ({M.param_count(params) / 1e9:.2f} B "
              f"parameters), {TRAIN_WIDE_BATCH}: loss {float(loss):.6f} "
              f"(CPU {float(loss_c):.6f}); launches {launches}; every "
              f"gradient within {worst[0]:.2e} of its scale ({worst[1]}), "
              f"{len(branch)} recurrent-branch leaves nonzero; adamw "
              f"update within {max(upd.values()):.2e} in norm")
        del params, grads, p_cpu, grads_c, p1_c, p1, st_c, st
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def watching_steps():
    """Within this context every ``TrainStep`` call is timed (host clock,
    ending in the loss read) and its loss kept, and the calls of the scans'
    backward helpers are counted (an eager step's, and its capture's)."""
    import importlib

    import torch
    from repro_torch.training import train_loop as tl
    rg = importlib.import_module("repro_torch.kernels.rglru.rglru")
    sd = importlib.import_module("repro_torch.kernels.ssd.ssd")
    seen = {"walls": [], "losses": [], "step": None, "batch": None,
            "backward_calls": {"rglru": 0, "ssd": 0}}
    real = (tl.TrainStep.__call__, rg.rglru_scan_backward,
            sd.ssd_chunk_scan_backward)

    def call(self, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = real[0](self, batch)
        loss = float(metrics["loss"])
        seen["walls"].append(1e3 * (time.perf_counter() - t))
        seen["losses"].append(loss)
        seen["step"], seen["batch"] = self, batch
        return metrics

    def counted(kind, fn):
        def wrapper(*args, **kw):
            seen["backward_calls"][kind] += 1
            return fn(*args, **kw)
        return wrapper

    tl.TrainStep.__call__ = call
    rg.rglru_scan_backward = counted("rglru", real[1])
    sd.ssd_chunk_scan_backward = counted("ssd", real[2])
    try:
        yield seen
    finally:
        (tl.TrainStep.__call__, rg.rglru_scan_backward,
         sd.ssd_chunk_scan_backward) = real


def _train_cli(args: list) -> tuple[int, list]:
    """``repro_torch.training.cli.main(args)`` in process: (exit code,
    its output lines, printed indented)."""
    import io

    from repro_torch.training import cli
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(list(args))
    lines = text.getvalue().strip().splitlines()
    for line in lines:
        print(f"    train: {line}")
    return rc, lines


def train_trainer(name: str, args: list) -> dict:
    """(c) ``python -m repro_torch.training.cli`` in process at full width:
    TRAINER_STEPS captured steps (the first eager, then the capture, the
    rest replays); the losses finite; the scan's launches three a recurrent
    block a step (forward, remat, backward) and no other kernel; the
    replays' walls, one more step's profiled device time and idle share,
    and peak memory."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    arch = args[args.index("--arch") + 1]
    cfg = get_config(arch)
    if "--layers" in args:
        cfg = dataclasses.replace(cfg, n_layers=int(
            args[args.index("--layers") + 1]))
    blocks = _scan_blocks(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with watching_steps() as seen:
        rc, lines = _train_cli(args + ["--steps", str(TRAINER_STEPS)])
    wall_s = time.perf_counter() - t0
    launches = _held_launches(f"{name} trainer",
                              {k: 3 * n * TRAINER_STEPS
                               for k, n in blocks.items()})
    peak = torch.cuda.max_memory_allocated()
    losses = seen["losses"]
    if rc != 0 or len(losses) != TRAINER_STEPS or not all(
            math.isfinite(v) for v in losses):
        fail(f"{name} trainer: exit {rc}, losses {losses}")
    # The eager first step and the capture each call the backward helper
    # once a recurrent block; the replays run what the capture recorded.
    calls = {k: v // 2 for k, v in seen["backward_calls"].items() if v}
    if calls != {k: n for k, n in blocks.items() if n}:
        fail(f"{name} trainer: backward helper calls a step {calls}, "
             f"expected one a recurrent block {blocks}")
    step, batch = seen["step"], seen["batch"]
    if step.program.graphs() != 1:
        fail(f"{name} trainer: the step was not captured once")
    rows = device_rows(lambda: step(batch))
    dev = sum(r["device_us"] for r in rows) / 1e3
    replay = float(np.median(seen["walls"][1:]))
    out = {"args": args, "steps": TRAINER_STEPS, "losses": losses,
           "walls_ms": seen["walls"], "replay_median_ms": replay,
           "device_ms": dev, "idle": 1.0 - dev / replay,
           "peak_memory_gib": peak / 2**30, "launches": launches,
           "backward_per_step": calls, "total_s": wall_s,
           "profile": rows[:8], "params": sum(
               t.numel() for t in _tree_paths(step.params).values())}
    print(f"  {name} trainer ({out['params'] / 1e9:.3f} B parameters): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step "
          f"{seen['walls'][0]:.1f} ms (eager, then the capture), replays "
          f"median {replay:.3f} ms, device {dev:.3f} ms, idle "
          f"{100 * out['idle']:.1f} %; peak memory {out['peak_memory_gib']:.2f}"
          f" GiB; launches {launches}; {wall_s:.1f} s in all")
    if name in COMPOSED_BACKWARD_WALLS_MS:
        print(f"      replays median {replay:.3f} ms; with the composed ssd "
              f"backward {COMPOSED_BACKWARD_WALLS_MS[name]:.3f} ms (an "
              f"earlier run)")
    del step, batch, seen
    torch.cuda.empty_cache()
    return out


def train_captured_vs_eager(record: list) -> dict:
    """(d) TRAIN_CAPTURE_STEPS ``train`` steps of mamba2-780m one group deep
    (bfloat16 parameters, float32 moments) captured and eager from the same
    parameters: parameters, m, v and losses bit for bit; then the step's
    wall both ways (device time and idle share)."""
    import dataclasses

    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=1)
    B, S = TRAIN_CAPTURE_BATCH
    source = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B,
                                         seed=SEED))
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    runs = {}
    for jit in (True, False):
        params = tree_map(torch.clone, p0)
        _, state, report = tl.train(cfg, steps=TRAIN_CAPTURE_STEPS,
                                    batch_fn=source.batch, params=params,
                                    jit=jit)
        runs[jit] = (params, state, report)
    (pc, sc, rc), (pe, se, re_) = runs[True], runs[False]
    a = _tree_paths({"params": pc, "opt": sc})
    b = _tree_paths({"params": pe, "opt": se})
    differ = {k: max_err(a[k], b[k]) for k in a if not torch.equal(a[k], b[k])}
    if differ or rc.losses != re_.losses:
        fail(f"captured train steps are not eager's bit for bit: losses "
             f"{rc.losses} / {re_.losses}, leaves {differ}")
    record.append({"case": f"mamba2-780m x1 train captured vs eager x"
                           f"{TRAIN_CAPTURE_STEPS}", "bit_identical": True,
                   "ok": True})
    batch = source.batch(TRAIN_CAPTURE_STEPS)
    eager = tl.TrainStep(cfg, pe, se, opt.OptConfig(), jit=False)
    captured = tl.TrainStep(cfg, pc, sc, opt.OptConfig())
    walls = both_ways(f"mamba2-780m x1 train step {TRAIN_CAPTURE_BATCH}",
                      lambda: float(eager(batch)["loss"]),
                      lambda: float(captured(batch)["loss"]))
    print(f"  mamba2-780m x1: {TRAIN_CAPTURE_STEPS} train steps captured bit "
          f"for bit eager (parameters, m, v, losses {rc.losses})")
    out = {"losses": rc.losses, "walls": walls, "leaves": len(a)}
    del eager, captured, runs, pc, sc, pe, se, p0
    torch.cuda.empty_cache()
    return out


def train_restart(record: list) -> dict:
    """(e) The restart on the card: ``--fail-at 3`` with a checkpoint
    every two steps exits 42; ``--resume`` continues from step 2 to 6; the
    losses of steps 3-6 bit for bit those of a run with no failure."""
    import shutil
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    with watching_steps() as whole:
        rc0, _ = _train_cli(RESTART_ARGS)
    with watching_steps() as failed:
        rc1, _ = _train_cli(RESTART_ARGS + ["--ckpt", str(ckpt), "--fail-at",
                                            str(RESTART_FAIL_AT)])
    with watching_steps() as resumed:
        rc2, lines = _train_cli(RESTART_ARGS + ["--ckpt", str(ckpt),
                                                "--resume"])
    shutil.rmtree(ckpt, ignore_errors=True)
    if (rc0, rc1, rc2) != (0, 42, 0):
        fail(f"restart: exit codes {(rc0, rc1, rc2)}, expected (0, 42, 0)")
    if failed["losses"] != whole["losses"][:RESTART_FAIL_AT]:
        fail(f"restart: the failing run's losses {failed['losses']} are not "
             f"the first {RESTART_FAIL_AT} of {whole['losses']}")
    if resumed["losses"] != whole["losses"][2:]:
        fail(f"restart: resumed losses {resumed['losses']} are not steps "
             f"3-6 of the uninterrupted run {whole['losses'][2:]}")
    record.append({"case": "train restart: steps 3-6 after --resume",
                   "bit_identical": True, "ok": True})
    print(f"  restart: exit 42 after step {RESTART_FAIL_AT}, resumed from "
          f"step 2; steps 3-6 bit for bit the uninterrupted run's "
          f"({resumed['losses']})")
    return {"losses": whole["losses"], "resumed": resumed["losses"],
            "exit_codes": [rc0, rc1, rc2]}


def train_compiled_cli(expected_mmgrad: int) -> dict:
    """(f) ``--compiled``: gpt2_block's loss at (128, 1024) for
    TRAIN_STEPS steps through ``train_compiled`` (the phases captured):
    exit 0, losses finite, the backward's mmgrad launches those of the
    train path's TRAIN_STEPS steps at S = 128, no other kernel."""
    zero_counts()
    t0 = time.perf_counter()
    rc, lines = _train_cli(COMPILED_ARGS)
    wall_s = time.perf_counter() - t0
    launches = _held_launches("--compiled trainer",
                              {"mmgrad": expected_mmgrad})
    m = re.search(r"steps=(\d+) loss ([-\d.naif]+) -> ([-\d.naif]+)",
                  lines[-1] if lines else "")
    if rc != 0 or not m or int(m.group(1)) != TRAIN_STEPS or not all(
            math.isfinite(float(m.group(i))) for i in (2, 3)):
        fail(f"--compiled: exit {rc}, last line {lines[-1:]}")
    print(f"  --compiled: launches {launches}, {wall_s:.1f} s with the "
          f"compile")
    return {"launches": launches, "seconds": wall_s,
            "losses": [float(m.group(2)), float(m.group(3))]}


def train_phase(card: str, record: dict, expected_mmgrad: int) -> dict:
    """LM training on the card: (a) the scans' backwards, (b) float32
    gradients at full width card against CPU, (c) the trainer at full
    width, (d) captured against eager, (e) the restart, (f) --compiled."""
    print(f"card: {card}")
    checks = record["checks"]
    out = {}
    print(f"  (a) the scans through autograd at full width, "
          f"{TRAIN_RGLRU} and {TRAIN_SSD}:")
    out["scans"] = train_scans(checks)
    print(f"      ssd_chunk_scan's kernels at {SSD_LM_SHAPES}, L2-warm and "
          f"L2-cold, the composed backward beside them:")
    out["ssd_shapes"] = ssd_shapes(checks)
    print(f"  (b) float32 gradients at full width, one group deep, "
          f"{TRAIN_WIDE_BATCH}, card against CPU:")
    out["wide"] = train_wide(checks)
    print(f"  (c) the trainer at full width, {TRAINER_STEPS} captured steps:")
    out["trainer"] = {name: train_trainer(name, args)
                      for name, args in TRAINERS.items()}
    print("  (d) captured against eager:")
    out["captured"] = train_captured_vs_eager(checks)
    print("  (e) the restart:")
    out["restart"] = train_restart(checks)
    print("  (f) --compiled:")
    out["compiled"] = train_compiled_cli(expected_mmgrad)
    return out


# --------------------------------------------------------------------------
# The mesh phase: the LM stack's sharded steps on a 4 x 2 mesh of positions
# on the card (one process drives every position in lockstep, so the card
# shows the cost of the split, not scaling)
# --------------------------------------------------------------------------

MESH_SHAPE = ((4, 2), ("data", "model"))
# (a) mamba2-780m at full width and depth, bfloat16 parameters, float32
# moments: the global batch, two captured steps, then MESH_WALLS replays.
# The unsharded comparator is TrainStep over the same batch in MESH_ACCUM
# microbatches (the sharded step's four data blocks: a whole-batch
# backward does not fit beside the state), whose loss is the global
# token-weighted mean only when the microbatches hold equal token counts:
# so the batch masks no document boundary.
MESH_TRAIN_BATCH = (8, 2048)
MESH_TRAIN_STEPS = 2
MESH_ACCUM = 4
MESH_WALLS = 3
MESH_LOSS_RTOL = 1e-4
# With compute split over `model` the sums run in another order, so the
# step cannot be the unsharded one bit for bit.  Each comparison is
# measured against the noise that a reordering of the unsharded step's own
# sums makes, in this run: the unsharded step again with MESH_FLOOR_ACCUM
# microbatches (the "floor"), held to the unsharded step by the same
# measures.  For every parameter leaf, its distance from the unsharded
# step's over the unsharded update's size, ||p - p_u|| / ||p_u - p0||,
# must stay within MESH_FLOOR_TIMES the floor's or MESH_UPDATE_MIN, and
# under MESH_UPDATE_CAP whatever the floor (a sign-flipped update is 2, an
# update of twice the size 1), and the size of its update ||p - p0|| within
# MESH_FLOOR_TIMES the floor's departure from the unsharded update's size
# or MESH_SIZE_MIN (an update of half or twice the size is 0.5 off).  The
# count of parameter elements more than one bfloat16 step from the
# unsharded step's must stay within MESH_FLOOR_TIMES the floor's.  Each
# m and v leaf must be within UPDATE_TOL in norm of the unsharded step's,
# or MESH_FLOOR_TIMES its floor's distance, and under MESH_MV_CAP.
MESH_FLOOR_ACCUM = 8
MESH_FLOOR_TIMES = 4.0
MESH_UPDATE_MIN = 0.25
MESH_UPDATE_CAP = 0.75
MESH_SIZE_MIN = 0.05
MESH_MV_CAP = 0.25
# (b) recurrentgemma-9b at full width, three layers deep (rglru, rglru,
# attn), float32: the sharded prefill against the unsharded one.
MESH_PREFILL = (4, 512)
MESH_PREFILL_LAYERS = 3
# (c) gpt2-medium bfloat16: the sharded serve step at 8 slots, cache 1024.
# Its logits and every cache leaf are held to the unsharded ServeStep's
# within MESH_SERVE_BAND of their scale: the data blocks' products round
# apart from the whole batch's (about two bfloat16 steps of the largest
# logit, 1.26e-2 of scale, after 16 steps on an H100), while a data block decoding
# with its neighbour's cache rows moves them by far more (the control,
# printed each run, must exceed the band).  A token may differ only where
# the unsharded step's top-2 margin is within one bfloat16 step of its top
# logit.
MESH_SERVE = (8, 1024)
MESH_SERVE_STEPS = 16
MESH_SERVE_BAND = 2.5e-2
# The pull of the step on memory: its peak allocation above the resident
# state must stay under the whole cache's bytes (the cache is read and
# written where it lies, never gathered).  The walls of the serve step
# with compute replicated over `model` and of ServeStep, as PERF.md records
# them on an H100 80GB HBM3 at 700 W, printed beside this run's.
MESH_SERVE_REPLICATED_MS = (24.738, 8.624)
# (d) mixtral-8x22b at full width, MESH_MOE_LAYERS deep, float32: the
# sharded prefill (experts split over `model`) against the unsharded one,
# within LM_TOL of scale.  Two layers: the sharded state (about 20 GB), the
# units' weights gathered over `data` and the unsharded copy fit on one card.
MESH_MOE = (4, 512)
MESH_MOE_LAYERS = 2
# (e) The elastic restart: mamba2-780m one layer deep, float32, (4, 512);
# a failure after step 2 with a checkpoint every two steps on 4 x 2, then
# resume(shardings=...) onto 2 x 2 to step 4.
MESH_RESTART_BATCH = (4, 512)
MESH_RESTART_STEPS = 4
MESH_RESTART_FAIL_AT = 2
MESH_SMALL = ((2, 2), ("data", "model"))
# (f) compressed_allreduce of a 4M-element gradient a position over 8.
MESH_ALLREDUCE = (8, 4 * 1024 * 1024)
MESH_ALLREDUCE_TOL = 0.02


def bf16_steps(got, want) -> float:
    """The largest ``|got - want|`` in units of the bfloat16 spacing at
    ``want`` (1.0: the neighbouring bfloat16 number)."""
    import torch
    a, b = got.float(), want.float()
    e = torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126)))
    return float(((a - b).abs() / torch.exp2(e - 7)).max())


def _placed_bytes(tree, position: int) -> tuple[int, int]:
    """(the bytes a position holds of a placed tree, its specs' share:
    each leaf's bytes over the shards its spec splits it into)."""
    import math as _m
    from repro_torch.models.layers import tree_leaves
    held = share = 0
    for a in tree_leaves(tree):
        s = a.shards[position]
        held += s.numel() * s.element_size()
        parts = _m.prod(a.sharding.parts(d) for d in range(a.ndim))
        share += _m.prod(a.shape) * s.element_size() // parts
    return held, share


def _shard_ptrs(tree) -> list:
    from repro_torch.models.layers import tree_leaves
    return [s.data_ptr() for a in tree_leaves(tree) for s in a.shards]


def _shards_by_spec(name: str, tree) -> None:
    """Every position's shard of every placed leaf has its spec's local
    shape."""
    from repro_torch.models.layers import tree_leaves
    for a in tree_leaves(tree):
        want = a.sharding.shard_shape(a.shape)
        if any(tuple(s.shape) != want for s in a.shards):
            fail(f"{name}: a shard is not its spec's {want} "
                 f"({a.sharding.spec!r})")


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def mesh_train(card: str, record: list) -> dict:
    """(a) mamba2-780m at full width and depth on the 4 x 2 mesh: the
    unsharded TrainStep (MESH_ACCUM microbatches, captured) and two
    captured jit_train_step steps from the same state, each model position
    computing its heads; the loss within MESH_LOSS_RTOL, and the gathered
    parameters, m and v held to the unsharded step's within bands set from
    the floor, the unsharded step at MESH_FLOOR_ACCUM microbatches (bit
    for bit counted, not required: the split sums in another order);
    ssd_chunk_scan's forward and backward
    launches, one a block, data block and model position, and the heads
    each launch scans; every position's state bytes beside its spec's
    share and the peak memory; the captured steps bit for bit eager; walls
    and device time."""
    import importlib

    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.core.capture import clear_graphs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.layers import tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    sd = importlib.import_module("repro_torch.kernels.ssd.ssd")
    ssd_ops = importlib.import_module("repro_torch.kernels.ssd.ops")
    cfg = get_config("mamba2-780m")
    B, S = MESH_TRAIN_BATCH
    source = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B, seed=SEED,
                                         mask_boundaries=False))
    batches = [source.batch(i)
               for i in range(MESH_TRAIN_STEPS + MESH_WALLS + 1)]
    oc = opt.OptConfig()
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    blocks = _scan_blocks(cfg)["ssd"]
    mesh = make_debug_mesh(*MESH_SHAPE)
    data, model = mesh.shape["data"], mesh.shape["model"]
    out = {"params": M.param_count(p0), "batch": list(MESH_TRAIN_BATCH)}

    # the unsharded step
    pu, su = tree_map(torch.clone, p0), opt.adamw_init(p0)
    unsharded = tl.TrainStep(cfg, pu, su, oc, accum=MESH_ACCUM)
    losses_u, walls_u = [], []
    for i in range(MESH_TRAIN_STEPS):
        walls_u.append(_timed(lambda i=i: losses_u.append(
            float(unsharded(batches[i])["loss"]))))
    want = {k: v.cpu() for k, v in _tree_paths(
        {"params": pu, "m": su["m"], "v": su["v"]}).items()}
    for j in range(MESH_WALLS):
        walls_u.append(_timed(lambda j=j: float(
            unsharded(batches[MESH_TRAIN_STEPS + j])["loss"])))
    rows = device_rows(lambda: unsharded(batches[-1]))
    dev_u = sum(r["device_us"] for r in rows) / 1e3
    del unsharded, pu, su
    clear_graphs()
    torch.cuda.empty_cache()
    # the floor: the unsharded step over other microbatches
    pf, sf = tree_map(torch.clone, p0), opt.adamw_init(p0)
    floor_step = tl.TrainStep(cfg, pf, sf, oc, accum=MESH_FLOOR_ACCUM)
    losses_f = [float(floor_step(batches[i])["loss"])
                for i in range(MESH_TRAIN_STEPS)]
    floor = {k: v.cpu() for k, v in _tree_paths(
        {"params": pf, "m": sf["m"], "v": sf["v"]}).items()}
    del floor_step, pf, sf
    clear_graphs()
    torch.cuda.empty_cache()
    p0_cpu = {k: v.cpu() for k, v in _tree_paths({"params": p0}).items()}

    def state_distance(got) -> dict:
        """How far the state ``got(path)`` is from the unsharded step's:
        the elements more than one bfloat16 step off and the most steps,
        each parameter leaf's distance over its unsharded update's size
        and its update's size over the unsharded one's, each m / v leaf's
        distance in norm."""
        out = {"far": 0, "steps": 0.0, "update": {}, "size": {}, "mv": {}}
        for path, w in want.items():
            g = got(path)
            if path.startswith("/params"):
                gf, wf = g.float(), w.float()
                e = torch.floor(torch.log2(wf.abs().clamp(min=2.0 ** -126)))
                out["far"] += int(((gf - wf).abs() > torch.exp2(e - 7)).sum())
                out["steps"] = max(out["steps"], bf16_steps(g, w))
                du = float((wf - p0_cpu[path].float()).norm())
                if du > 0:
                    out["update"][path] = float((gf - wf).norm()) / du
                    out["size"][path] = float(
                        (gf - p0_cpu[path].float()).norm()) / du
            else:
                out["mv"][path] = float((g.float() - w).norm()
                                        / w.norm().clamp(min=1e-30))
        return out

    fl = state_distance(lambda path: floor[path])
    del floor

    def placed_state():
        sh = tl.train_state_shardings(p0, mesh, cfg)
        return (place(p0, sh["params"]),
                place(opt.adamw_init(p0), sh["opt"]))

    # the sharded step, captured
    ps, ss = placed_state()
    held = [_placed_bytes({"p": ps, "o": ss}, q) for q in range(mesh.size)]
    if any(h != s_ for h, s_ in held):
        fail(f"sharded train: a position holds other than its specs' share "
             f"{held}")
    # the unsharded state: the parameters and their float32 m and v
    whole_bytes = sum(t.numel() * (t.element_size() + 8)
                      for t in _tree_paths(p0).values())
    step = tl.jit_train_step(cfg, mesh, p0, batches[0], oc)
    ptrs = _shard_ptrs({"p": ps, "o": ss})
    calls = {"backward": 0}
    real_bwd = sd.ssd_chunk_scan_backward
    real_states = ssd_ops.ssd_states
    block_rows = MESH_TRAIN_BATCH[0] // data
    heads_seen = set()

    def counted(*a, **kw):
        calls["backward"] += 1
        return real_bwd(*a, **kw)

    def states_seen(st, dec, **kw):
        heads_seen.add(st.shape[1] // block_rows)
        return real_states(st, dec, **kw)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses_s, walls_s = [], []
    sd.ssd_chunk_scan_backward = counted
    ssd_ops.ssd_states = states_seen
    try:
        for i in range(MESH_TRAIN_STEPS):
            walls_s.append(_timed(lambda i=i: losses_s.append(
                float(step(ps, ss, batches[i])[2]["loss"]))))
    finally:
        sd.ssd_chunk_scan_backward = real_bwd
        ssd_ops.ssd_states = real_states
    heads = cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim
    if heads_seen != {heads // model}:
        fail(f"sharded train: ssd_chunk_scan scanned {sorted(heads_seen)} "
             f"heads a launch, expected a model position's {heads // model}")
    per_step = 3 * blocks * data * model
    launches = _held_launches("sharded mamba2-780m train steps",
                              {"ssd": per_step * MESH_TRAIN_STEPS})
    peak = torch.cuda.max_memory_allocated()
    # the first call runs eagerly and then captures (each calls the backward
    # helper once a block and unit); the replay runs what the capture
    # recorded
    bwd_launches = calls["backward"] // 2 * MESH_TRAIN_STEPS
    if calls["backward"] != 2 * blocks * data * model:
        fail(f"sharded train: backward helper calls {calls['backward']}, "
             f"expected one a block, data block and model position, eager "
             f"and captured")
    if _shard_ptrs({"p": ps, "o": ss}) != ptrs:
        fail("sharded train: the state was not written in place")
    _shards_by_spec("sharded train", {"p": ps, "o": ss})
    if step.runner.program is None or step.runner.program.graphs() != 1:
        fail("sharded train: the step was not captured once")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_s, losses_u))
    floor_loss_rel = max(abs(a - b) / abs(b)
                         for a, b in zip(losses_f, losses_u))
    if not loss_rel <= MESH_LOSS_RTOL:
        fail(f"sharded train: losses {losses_s} against {losses_u} "
             f"({loss_rel:.3e}; the floor's {losses_f}, {floor_loss_rel:.3e})")
    got = {k: v.gather().cpu() for k, v in _tree_paths(
        {"params": ps, "m": ss["m"], "v": ss["v"]}).items()}
    exact = sum(int(torch.equal(got[k], w)) for k, w in want.items())
    sd = state_distance(lambda k: got[k])
    del got

    def worst(measure, band) -> tuple:
        """(the leaf nearest its band, its value, its band) of a per-leaf
        measure whose band ``band(leaf)`` is set from the floor."""
        k = max(sd[measure], key=lambda k: sd[measure][k] / band(k))
        return k, sd[measure][k], band(k)

    band_update = {k: min(MESH_UPDATE_CAP, max(
        MESH_UPDATE_MIN, MESH_FLOOR_TIMES * fl["update"].get(k, 0.0)))
        for k in sd["update"]}
    band_size = {k: max(MESH_SIZE_MIN, MESH_FLOOR_TIMES * abs(
        fl["size"].get(k, 1.0) - 1.0)) for k in sd["size"]}
    band_mv = {k: min(MESH_MV_CAP, max(
        UPDATE_TOL, MESH_FLOOR_TIMES * fl["mv"][k])) for k in sd["mv"]}
    for k in sd["size"]:
        sd["size"][k] = abs(sd["size"][k] - 1.0)
    w_up, w_sz, w_mv = (worst("update", band_update.get),
                        worst("size", band_size.get),
                        worst("mv", band_mv.get))
    far_band = MESH_FLOOR_TIMES * fl["far"]
    print(f"      against the unsharded step (the floor, accum "
          f"{MESH_FLOOR_ACCUM} against {MESH_ACCUM}, in brackets): "
          f"{sd['far']} parameter elements beyond one bfloat16 step "
          f"({fl['far']}; band {far_band:.0f}), at most {sd['steps']:.1f} "
          f"steps ({fl['steps']:.1f}); update distances up to "
          f"{max(sd['update'].values()):.3e} ({max(fl['update'].values()):.3e}),"
          f" nearest its band {w_up[0]} {w_up[1]:.3e} against {w_up[2]:.3e};"
          f" update sizes off by up to {max(sd['size'].values()):.3e}, "
          f"nearest its band {w_sz[0]} {w_sz[1]:.3e} against "
          f"{w_sz[2]:.3e}; m / v up to {max(sd['mv'].values()):.3e} "
          f"({max(fl['mv'].values()):.3e}), nearest its band {w_mv[0]} "
          f"{w_mv[1]:.3e} against {w_mv[2]:.3e}")
    if not sd["far"] <= far_band:
        fail(f"sharded train: {sd['far']} parameter elements beyond one "
             f"bfloat16 step of the unsharded step's, over {MESH_FLOOR_TIMES}"
             f" x the floor's {fl['far']}")
    for name, (k, v, band) in (("update distance", w_up),
                               ("update size", w_sz), ("m / v", w_mv)):
        if not v <= band:
            fail(f"sharded train: {name} of {k} {v:.3e} beyond its band "
                 f"{band:.3e}")
    record.append({"case": "mamba2-780m 4x2 sharded train vs unsharded",
                   "loss_rel": loss_rel, "floor_loss_rel": floor_loss_rel,
                   "param_far": sd["far"],
                   "param_bf16_steps": sd["steps"],
                   "update_rel": sd["update"], "update_size_off": sd["size"],
                   "mv_norm_rel_leaves": sd["mv"],
                   "bands": {"far": far_band, "update": band_update,
                             "size": band_size, "mv": band_mv},
                   "floor": fl, "bit_identical_leaves": exact,
                   "leaves": len(want), "ok": True})
    steps_max, norm_max = sd["steps"], max(sd["mv"].values())

    # the same steps eagerly, from the same state: bit for bit
    pe, se = placed_state()
    eager = tl.jit_train_step(cfg, mesh, p0, batches[0], oc, jit=False)
    losses_e = [float(eager(pe, se, batches[i])[2]["loss"])
                for i in range(MESH_TRAIN_STEPS)]
    a = _tree_paths({"p": ps, "o": ss})
    b = _tree_paths({"p": pe, "o": se})
    differ = [k for k in a if not all(torch.equal(x, y) for x, y in zip(
        a[k].shards, b[k].shards))]
    if differ or losses_e != losses_s:
        fail(f"sharded train: captured steps are not eager's bit for bit: "
             f"losses {losses_s} / {losses_e}, leaves {differ[:4]}")
    record.append({"case": "mamba2-780m 4x2 sharded train captured vs eager",
                   "bit_identical": True, "ok": True})
    del pe, se, eager
    torch.cuda.empty_cache()
    for j in range(MESH_WALLS):
        walls_s.append(_timed(lambda j=j: float(step(
            ps, ss, batches[MESH_TRAIN_STEPS + j])[2]["loss"])))
    rows_s = device_rows(lambda: step(ps, ss, batches[-1]))
    dev_s = sum(r["device_us"] for r in rows_s) / 1e3
    rep_u = float(np.median(walls_u[1:]))
    rep_s = float(np.median(walls_s[1:]))
    out.update({
        "losses": losses_s, "losses_unsharded": losses_u,
        "losses_floor": losses_f,
        "loss_rel": loss_rel, "param_bf16_steps": steps_max,
        "param_far": sd["far"], "floor_param_far": fl["far"],
        "mv_norm_rel": norm_max, "floor_mv_norm_rel": max(fl["mv"].values()),
        "bit_identical_leaves": exact,
        "leaves": len(want), "launches": launches,
        "ssd_heads_per_launch": heads // model,
        "ssd_per_step": per_step, "ssd_backward": bwd_launches,
        "ssd_forward": launches["ssd"] - bwd_launches,
        "held_bytes": [h for h, _ in held], "share_bytes": [s_ for _, s_ in
                                                           held],
        "whole_state_bytes": whole_bytes, "peak_memory_gib": peak / 2**30,
        "walls_ms": walls_s, "walls_unsharded_ms": walls_u,
        "replay_median_ms": rep_s, "replay_median_unsharded_ms": rep_u,
        "device_ms": dev_s, "device_unsharded_ms": dev_u,
        "idle": 1.0 - dev_s / rep_s, "idle_unsharded": 1.0 - dev_u / rep_u,
        "profile": rows_s[:8], "profile_unsharded": rows[:8]})
    print(f"  (a) mamba2-780m ({out['params'] / 1e9:.3f} B parameters), "
          f"global batch {MESH_TRAIN_BATCH}, 4x2: losses {losses_s} against "
          f"unsharded {losses_u} ({loss_rel:.2e}; the floor's "
          f"{floor_loss_rel:.2e}); {sd['far']} parameter "
          f"elements beyond one bfloat16 step (floor {fl['far']}), m / v "
          f"within {norm_max:.2e} in norm (floor "
          f"{max(fl['mv'].values()):.2e}), {exact} of {len(want)} leaves bit "
          f"for bit; captured steps bit for bit eager")
    print(f"      ssd_chunk_scan launches {launches['ssd']} in "
          f"{MESH_TRAIN_STEPS} steps ({per_step} a step: "
          f"{out['ssd_forward'] // MESH_TRAIN_STEPS} forward and remat, "
          f"{bwd_launches // MESH_TRAIN_STEPS} backward), each over "
          f"{heads // model} of {heads} heads x {block_rows} rows (a model "
          f"position's); state a position "
          f"{held[0][0] / 2**20:.1f} MiB (its specs' share "
          f"{held[0][1] / 2**20:.1f}; the whole state "
          f"{whole_bytes / 2**20:.1f} / 8 = {whole_bytes / 8 / 2**20:.1f});"
          f" peak {out['peak_memory_gib']:.2f} GiB")
    print(f"      {card}: replays sharded {rep_s:.3f} ms (device "
          f"{dev_s:.3f}, idle {100 * out['idle']:.1f} %), unsharded "
          f"{rep_u:.3f} ms (device {dev_u:.3f}); first calls "
          f"{walls_s[0]:.1f} / {walls_u[0]:.1f} ms (eager, then the capture)")
    print(f"      sharded replays {rep_s:.3f} ms; with the composed ssd "
          f"backward {COMPOSED_BACKWARD_WALLS_MS['mamba2-780m 4x2']:.3f} ms "
          f"(an earlier run)")
    del step, ps, ss, p0, want
    clear_graphs()
    torch.cuda.empty_cache()
    return out


def mesh_prefill(card: str, record: list) -> dict:
    """(b) recurrentgemma-9b at full width, MESH_PREFILL_LAYERS deep,
    float32: jit_prefill_step at MESH_PREFILL on the 4 x 2 mesh against the
    unsharded prefill within LM_TOL of scale; rglru_scan launched once a
    RG-LRU block, data block and model position, over that position's
    channels, each launch held against its plain version at its shape;
    walls both ways."""
    import dataclasses

    import numpy as np
    import torch
    import repro_torch.kernels.rglru.ops as rglru_ops
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_shardings, place
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_plain
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import generator as gen
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              n_layers=MESH_PREFILL_LAYERS, dtype="float32")
    B, S = MESH_PREFILL
    mesh = make_debug_mesh(*MESH_SHAPE)
    data, model = mesh.shape["data"], mesh.shape["model"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    batch = M.make_batch(cfg, batch=B, seq=S, kind="prefill", seed=SEED)
    want = tf.prefill(params, batch, cfg)
    placed = place(params, param_shardings(params, mesh, cfg))
    step = gen.jit_prefill_step(cfg, mesh, params, batch)
    seen = []
    real = rglru_ops.rglru

    def rec(a, b, **kw):
        seen.append((a.clone(), b.clone(), kw))
        return real(a, b, **kw)

    rglru_ops.rglru = rec
    try:
        step(placed, batch)
    finally:
        rglru_ops.rglru = real
    zero_counts()
    got = step(placed, batch)
    torch.cuda.synchronize()
    rec_blocks = _scan_blocks(cfg)["rglru"]
    launches = _held_launches("sharded recurrentgemma-9b prefill",
                              {"rglru": rec_blocks * data * model})
    channels = sorted({a.shape[-1] for a, _, _ in seen})
    if channels != [cfg.d_model // model]:
        fail(f"sharded prefill: rglru_scan over {channels} channels a "
             f"launch, expected a model position's {cfg.d_model // model}")
    rel = check_scaled(record, "recurrentgemma-9b x3 4x2 prefill vs "
                               "unsharded", got, want, LM_TOL) / float(
        want.abs().max())
    x, y, kw = seen[0]
    ch = kw["chunk"]
    shape = "x".join(map(str, x.shape))
    err = check(record, f"rglru_scan sharded prefill {shape}",
                rglru_scan(x, y, chunk=ch), rglru_scan_plain(x, y, chunk=ch),
                RGLRU_TOL)
    n = x.numel()
    m = _measure_scan(f"rglru_scan sharded prefill {shape}",
                      lambda: rglru_scan(x, y, chunk=ch),
                      lambda: rglru_scan_plain(x, y, chunk=ch), 2.0 * n,
                      4.0 * 3 * n, err)
    m["shape"] = list(x.shape)
    sharded_ms = [_timed(lambda: step(placed, batch))
                  for _ in range(MESH_WALLS)]
    plain_ms = [_timed(lambda: tf.prefill(params, batch, cfg))
                for _ in range(MESH_WALLS)]
    rows = device_rows(lambda: step(placed, batch))
    dev = sum(r["device_us"] for r in rows) / 1e3
    out = {"layers": cfg.n_layers, "params": M.param_count(params),
           "rel_err": rel, "launches": launches, "rglru": m,
           "rglru_channels_per_launch": channels[0],
           "walls_ms": sharded_ms, "walls_unsharded_ms": plain_ms,
           "device_ms": dev, "profile": rows[:8]}
    print(f"  (b) recurrentgemma-9b x{cfg.n_layers} f32 prefill {MESH_PREFILL}"
          f", 4x2: logits within {rel:.2e} of scale of the unsharded prefill;"
          f" rglru_scan launches {launches['rglru']} ({rec_blocks} a data "
          f"block and model position), each over {channels[0]} of "
          f"{cfg.d_model} channels")
    print(f"      {card}: sharded {np.median(sharded_ms):.3f} ms (device "
          f"{dev:.3f}), unsharded {np.median(plain_ms):.3f} ms")
    del params, placed, want, got, seen
    torch.cuda.empty_cache()
    return out


def mesh_serve(card: str, record: list) -> dict:
    """(c) gpt2-medium bfloat16: jit_serve_step at MESH_SERVE on the 4 x 2
    mesh, MESH_SERVE_STEPS captured decode steps (heads, d_ff and vocab
    split over `model`), against the unsharded ServeStep fed the same
    tokens: the logits every step and every gathered cache leaf after the
    last within MESH_SERVE_BAND of scale; a token differs only at a top-2
    margin within one bfloat16 step of the top logit (printed); the
    control (one block's cache rows shifted to its neighbour's) beyond the
    band; the cache shards written in place; the first call's peak
    allocation above the resident state under the whole cache's bytes
    (nothing of the cache gathered); walls both ways beside those of the
    step with compute replicated over `model`."""
    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (as_shardings,
                                                  cache_batch_dim,
                                                  cache_specs,
                                                  param_shardings, place)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import generator as gen
    cfg = get_config("gpt2-medium")
    slots, C = MESH_SERVE
    mesh = make_debug_mesh(*MESH_SHAPE)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    placed = place(params, param_shardings(params, mesh, cfg))
    cache_u = tf.init_cache(cfg, slots, C)
    cshard = as_shardings(cache_specs(cache_u, mesh, cfg), mesh)
    cache_s = place(tf.init_cache(cfg, slots, C), cshard)
    unsharded = gen.ServeStep(cfg, params, cache_u, slots)
    step = gen.jit_serve_step(cfg, mesh, params, cache_s)
    ptrs = _shard_ptrs(cache_s)
    tok = np.random.default_rng(SEED).integers(0, cfg.vocab, slots).astype(
        np.int32)

    def rel(got, want) -> float:
        w = want.float()
        return float((got.float() - w).abs().max() / w.abs().max())

    differ, margins, log_rels = 0, [], []
    walls_s, walls_u = [], []
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _tree_paths(cache_u).values())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MESH_SERVE_STEPS):
        t0 = time.perf_counter()
        nxt, logits, cache_s = step(placed, tok, cache_s)
        if i == 0:
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - resident
            if not step_peak < cache_bytes:
                fail(f"sharded serve: the step's peak {step_peak} B above "
                     f"the resident state is not under the whole cache's "
                     f"{cache_bytes} B")
        got = np.asarray(nxt)
        walls_s.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        nxt_u, logits_u = unsharded(tok)
        want = nxt_u.cpu().numpy()
        walls_u.append(1e3 * (time.perf_counter() - t0))
        log_rels.append(rel(logits, logits_u))
        for j in np.nonzero(got != want)[0]:
            top = torch.topk(logits_u[j].float(), 2).values
            margin = float(top[0] - top[1])
            steps = margin / 2.0 ** (np.floor(np.log2(abs(float(top[0]))))
                                     - 7)
            margins.append({"step": i, "slot": int(j), "top": float(top[0]),
                            "margin": margin, "bf16_steps": steps})
            print(f"      step {i} slot {j}: token {got[j]} against "
                  f"{want[j]}, top logit {float(top[0]):.4f}, top-2 margin "
                  f"{margin:.3e} ({steps:.2f} bfloat16 steps)")
            if steps > 1.0:
                fail(f"sharded serve: step {i} slot {j} differs at a top-2 "
                     f"margin of {steps:.2f} bfloat16 steps (> 1)")
            differ += 1
        tok = want
    log_rel = max(log_rels)
    if log_rel > MESH_SERVE_BAND:
        fail(f"sharded serve: logits {log_rel:.3e} of scale from the "
             f"unsharded step's (band {MESH_SERVE_BAND})")
    if _shard_ptrs(cache_s) != ptrs:
        fail("sharded serve: the cache shards were not written in place")
    _shards_by_spec("sharded serve cache", cache_s)
    gathered = {k: v.gather() for k, v in _tree_paths(cache_s).items()}
    cache_rel = {}
    for path, w in _tree_paths(cache_u).items():
        g = gathered[path]
        if w.dim() == 0:
            if not torch.equal(g, w):
                fail(f"sharded serve: pos {g} against {w}")
            continue
        cache_rel[path] = rel(g, w)
    worst = max(cache_rel, key=cache_rel.get)
    if cache_rel[worst] > MESH_SERVE_BAND:
        fail(f"sharded serve: cache {worst} {cache_rel[worst]:.3e} of scale "
             f"from the unsharded step's (band {MESH_SERVE_BAND})")
    # The control: the sharded step, eager, on the unsharded cache with
    # each data block's rows taken from the next block's (rolled by one
    # block), against the unsharded decode on that cache as it is.
    from repro_torch.models.layers import tree_from_paths
    paths_u = _tree_paths(cache_u)
    block = slots // mesh.shape["data"]
    shifted = tree_from_paths(cache_u, {
        path: (w.clone() if cache_batch_dim(path.lstrip("/"), w.dim())
               is None else w.roll(block, cache_batch_dim(path.lstrip("/"),
                                                          w.dim())))
        for path, w in paths_u.items()}, "")
    control_step = gen.jit_serve_step(cfg, mesh, params, cache_u, jit=False)
    _, lg_bad, _ = control_step(placed, tok, place(shifted, cshard))
    plain = tree_from_paths(cache_u, {path: w.clone() for path, w in
                                      paths_u.items()}, "")
    lg_ref, _ = tf.decode_step(params, torch.as_tensor(tok, device="cuda"),
                               plain, cfg)
    control = rel(lg_bad, lg_ref)
    if control <= MESH_SERVE_BAND:
        fail(f"sharded serve: the control (cache rows shifted by a block) "
             f"moves the logits only {control:.3e} of scale, within the "
             f"band {MESH_SERVE_BAND}: the check cannot see a wrong cache")
    del shifted, plain, control_step
    record.append({"case": "gpt2-medium 4x2 sharded serve vs ServeStep",
                   "step_peak_bytes": step_peak, "cache_bytes": cache_bytes,
                   "tokens_differ": differ, "logits_rel": log_rel,
                   "logits_rel_steps": log_rels, "cache_rel": cache_rel,
                   "control_rel": control, "band": MESH_SERVE_BAND,
                   "margins": margins, "ok": True})
    rows = device_rows(lambda: step(placed, tok, cache_s))
    dev = sum(r["device_us"] for r in rows) / 1e3
    rows_u = device_rows(lambda: unsharded(tok))
    dev_u = sum(r["device_us"] for r in rows_u) / 1e3
    rep_s, rep_u = float(np.median(walls_s[1:])), float(np.median(walls_u[1:]))
    out = {"steps": MESH_SERVE_STEPS, "tokens_differ": differ,
           "step_peak_bytes": step_peak, "cache_bytes": cache_bytes,
           "resident_bytes": resident,
           "margins": margins, "logits_rel": log_rel,
           "logits_rel_steps": log_rels, "cache_rel": cache_rel,
           "control_rel": control, "band": MESH_SERVE_BAND,
           "walls_ms": walls_s, "walls_unsharded_ms": walls_u,
           "median_ms": rep_s, "median_unsharded_ms": rep_u,
           "device_ms": dev, "device_unsharded_ms": dev_u,
           "profile": rows[:8], "graphs": step.runner.program.graphs()}
    print(f"  (c) gpt2-medium bf16 serve {MESH_SERVE}, 4x2, "
          f"{MESH_SERVE_STEPS} captured steps: {differ} tokens differ from "
          f"the unsharded ServeStep's; logits within {log_rel:.3e} of scale,"
          f" cache within {cache_rel[worst]:.3e} ({worst}), band "
          f"{MESH_SERVE_BAND}; control (rows shifted a block) {control:.3e};"
          f" cache shards written in place")
    print(f"      first call's peak above the resident state "
          f"{step_peak / 2**20:.1f} MiB, under the whole cache's "
          f"{cache_bytes / 2**20:.1f} MiB (resident {resident / 2**30:.2f} "
          f"GiB)")
    print(f"      {card}: step sharded {rep_s:.3f} ms (device {dev:.3f}), "
          f"unsharded {rep_u:.3f} ms (device {dev_u:.3f}); first call "
          f"{walls_s[0]:.1f} ms (eager, then the capture); with compute "
          f"replicated over model (PERF.md): {MESH_SERVE_REPLICATED_MS[0]}"
          f" / {MESH_SERVE_REPLICATED_MS[1]} ms")
    del step, unsharded, placed, params, cache_s, cache_u
    torch.cuda.empty_cache()
    return out


def mesh_moe(card: str, record: list) -> dict:
    """(d) mixtral-8x22b at full width, MESH_MOE_LAYERS deep, float32:
    jit_prefill_step at MESH_MOE on the 4 x 2 mesh, its eight experts
    split four a model position (the router, top-k and dispatch every
    position's, so the drops are the unsharded step's), against the
    unsharded prefill within LM_TOL of scale; walls both ways."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import param_shardings, place
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import generator as gen
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              n_layers=MESH_MOE_LAYERS, dtype="float32")
    B, S = MESH_MOE
    mesh = make_debug_mesh(*MESH_SHAPE)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    n_params = M.param_count(params)
    batch = M.make_batch(cfg, batch=B, seq=S, kind="prefill", seed=SEED)
    want = tf.prefill(params, batch, cfg)
    plain_ms = [_timed(lambda: tf.prefill(params, batch, cfg))
                for _ in range(MESH_WALLS)]
    placed = place(params, param_shardings(params, mesh, cfg))
    spec = placed["groups"]["b0_attn"]["mlp"]["w_in"].sharding.spec
    del params
    torch.cuda.empty_cache()
    if spec[1] != "model":
        fail(f"sharded MoE: the experts are not split over model ({spec!r})")
    step = gen.jit_prefill_step(cfg, mesh, placed, batch)
    zero_counts()
    got = step(placed, batch)
    torch.cuda.synchronize()
    _held_launches("sharded mixtral-8x22b prefill", {})
    rel = check_scaled(record, f"mixtral-8x22b x{MESH_MOE_LAYERS} 4x2 "
                               f"prefill vs unsharded", got, want,
                       LM_TOL) / float(want.abs().max())
    sharded_ms = [_timed(lambda: step(placed, batch))
                  for _ in range(MESH_WALLS)]
    rows = device_rows(lambda: step(placed, batch))
    dev = sum(r["device_us"] for r in rows) / 1e3
    out = {"layers": cfg.n_layers, "params": n_params, "rel_err": rel,
           "expert_spec": list(map(str, spec)), "walls_ms": sharded_ms,
           "walls_unsharded_ms": plain_ms, "device_ms": dev,
           "profile": rows[:8]}
    print(f"  (d) mixtral-8x22b x{cfg.n_layers} f32 ({n_params / 1e9:.2f} B "
          f"parameters) prefill {MESH_MOE}, 4x2, experts {spec!r}: logits "
          f"within {rel:.2e} of scale of the unsharded prefill")
    print(f"      {card}: sharded {np.median(sharded_ms):.3f} ms (device "
          f"{dev:.3f}), unsharded {np.median(plain_ms):.3f} ms")
    del placed, want, got, step
    torch.cuda.empty_cache()
    return out


def mesh_restart(card: str, record: list) -> dict:
    """(e) The elastic restart: mamba2-780m one layer deep, float32,
    MESH_RESTART_BATCH: train on 4 x 2 with a checkpoint every two steps
    and a failure after step MESH_RESTART_FAIL_AT, resume(shardings=...)
    onto 2 x 2 to step MESH_RESTART_STEPS; the resumed losses within
    MESH_LOSS_RTOL and the final parameters, m and v within GRAD_TOL of
    each leaf's scale of an uninterrupted run on 4 x 2."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import models as M
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import PlacedArray, place
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.training import train_loop as tl
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=1,
                              dtype="float32")
    B, S = MESH_RESTART_BATCH
    source = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B,
                                         seed=SEED))
    big, small = make_debug_mesh(*MESH_SHAPE), make_debug_mesh(*MESH_SMALL)
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    sh = tl.train_state_shardings(p0, big, cfg)
    pw, sw, whole = tl.train(cfg, steps=MESH_RESTART_STEPS,
                             batch_fn=source.batch,
                             params=place(tree_map(torch.clone, p0),
                                          sh["params"]))
    ckpt = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ck = Checkpointer(ckpt)
    try:
        tl.train(cfg, steps=MESH_RESTART_STEPS, batch_fn=source.batch,
                 checkpointer=ck, checkpoint_every=2,
                 fail_at=MESH_RESTART_FAIL_AT,
                 params=place(tree_map(torch.clone, p0), sh["params"]))
    except tl.SimulatedFailure:
        pass
    else:
        fail("restart on the mesh: the injected failure did not raise")
    ck.wait()
    p, s, rep = tl.resume(cfg, ck, steps=MESH_RESTART_STEPS,
                          batch_fn=source.batch,
                          shardings=tl.train_state_shardings(p0, small, cfg))
    shutil.rmtree(ckpt, ignore_errors=True)
    if not all(isinstance(a, PlacedArray) and a.sharding.mesh is small
               for a in tree_leaves({"p": p, "s": s})):
        fail("restart on the mesh: the resumed state is not on the 2x2 mesh")
    _shards_by_spec("resumed state", {"p": p, "s": s})
    want = whole.losses[MESH_RESTART_FAIL_AT:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rep.losses, want))
    if len(rep.losses) != len(want) or not rel <= MESH_LOSS_RTOL:
        fail(f"restart on the mesh: resumed losses {rep.losses} against "
             f"{want}")
    got = _tree_paths({"p": p, "m": s["m"], "v": s["v"]})
    ref = _tree_paths({"p": pw, "m": sw["m"], "v": sw["v"]})
    worst = 0.0
    for path, w in ref.items():
        w = w.gather()
        worst = max(worst, scaled(f"restart {path}", max_err(
            got[path].gather(), w), float(w.abs().max().clamp(min=1e-30)),
            GRAD_TOL))
    record.append({"case": "mamba2-780m x1 restart 4x2 -> 2x2",
                   "loss_rel": rel, "state_rel": worst, "ok": True})
    print(f"  (e) restart: failure after step {MESH_RESTART_FAIL_AT} on 4x2, "
          f"resumed onto 2x2 to step {MESH_RESTART_STEPS}: losses "
          f"{rep.losses} against {want} ({rel:.2e}), state within "
          f"{worst:.2e} of scale of the uninterrupted run")
    return {"losses": rep.losses, "uninterrupted": whole.losses,
            "loss_rel": rel, "state_rel": worst}


def mesh_allreduce(card: str, record: list) -> dict:
    """(f) compressed_allreduce under shard_map over 8 positions on the
    card against the plain sum: relative error under MESH_ALLREDUCE_TOL
    (the reference's test holds its own to the same), every position's
    result the same."""
    import torch
    from repro_torch.distributed.compression import compressed_allreduce
    from repro_torch.distributed.sharding import P, shard_map
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh((MESH_ALLREDUCE[0],), ("data",))
    g = torch.randn(MESH_ALLREDUCE, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 400), device="cuda") * 1e-2

    def worker(x):
        red, _ = compressed_allreduce({"g": x[0]}, {}, ("data",))
        return red["g"][None]

    run = shard_map(worker, mesh=mesh, in_specs=P("data"),
                    out_specs=P("data"))
    red = run(g)
    want = g.sum(0)
    err = float((red[0] - want).abs().max() / want.abs().max())
    if not err < MESH_ALLREDUCE_TOL or not all(
            torch.equal(red[0], r) for r in red):
        fail(f"compressed all-reduce: error {err:.3e} against the plain sum "
             f"(band {MESH_ALLREDUCE_TOL}), or positions disagree")
    walls = [_timed(lambda: run(g)) for _ in range(MESH_WALLS)]
    record.append({"case": "compressed_allreduce 8 positions", "rel_err": err,
                   "tol": MESH_ALLREDUCE_TOL, "ok": True})
    print(f"  (f) compressed_allreduce over 8 positions of "
          f"{MESH_ALLREDUCE[1]} elements: {err:.3e} of the plain sum's scale "
          f"(band {MESH_ALLREDUCE_TOL}); {card}: {min(walls):.3f} ms a call")
    return {"rel_err": err, "walls_ms": walls}


def mesh_phase(card: str, record: dict) -> dict:
    """The LM stack on a 4 x 2 mesh of positions on the card, compute split
    over `model`: (a) sharded training, (b) the sharded prefill, (c) the
    sharded serve step, (d) the sharded MoE prefill, (e) the elastic
    restart, (f) the compressed all-reduce."""
    import torch
    print(f"card: {card}")
    checks = record["checks"]
    out = {"train": mesh_train(card, checks)}
    out["ssd"] = scan_autograd(
        "ssd", _ssd_local_shape(), torch.Generator(device="cuda").manual_seed(
            SEED + 410), checks)
    out["prefill"] = mesh_prefill(card, checks)
    out["serve"] = mesh_serve(card, checks)
    out["moe"] = mesh_moe(card, checks)
    out["restart"] = mesh_restart(card, checks)
    out["allreduce"] = mesh_allreduce(card, checks)
    return out


# The rank phase: the mesh split over ranks, one process a card
# (src/repro_torch/launch/ranks.py: spawn, launch/mesh.py: rank_mesh).
# (a) one NCCL rank: mamba2-780m at full width and depth on 4 x 2,
# RANK_STEPS captured steps from the seeded state mesh_train starts from,
# bit for bit the same steps eager on the rank and the single-process
# captured step run in the same process; the all-gathers captured into
# the graph; walls and device time.  (b) gpt2_block (RANK_PROGRAM_S, 1024)
# on 4 x 2 over one NCCL rank with jit=True, strategies replicate (flash
# and the chain routed) and dp_tp (the chain routed, the plan's psums and
# gathers through NCCL): verify(), bit for bit the single-process
# program, the routed kernels launched.  (c) two gloo ranks on the one
# card, eagerly: mamba2-780m RANK_GLOO_LAYERS layers deep (the depth cut:
# two processes each hold an eager step's temporaries) bit for bit the
# single-process step.  (d) with two cards or more, NCCL over
# min(count, 4) cards with (a) and (b); otherwise one line says why not.
RANK_STEPS = 2
RANK_WALLS = 3
RANK_GLOO_LAYERS = 4
RANK_PROGRAM_S = 128
RANK_PROGRAM_STRATEGIES = ("replicate", "dp_tp")
RANK_TIMEOUT = 900


def _rank_setup() -> None:
    """A rank's process as main() sets the parent's: forced routing, full
    float32 matmuls, the kernels loaded from the parent's build."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["CODO_FORCE_PALLAS"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    if "jax" in sys.modules:
        fail("a rank imported jax")


def _nccl_rows(rows: list) -> list:
    return [r for r in rows if "nccl" in r["name"].lower()]


@contextlib.contextmanager
def counting_all_gathers():
    """Count the ``torch.distributed.all_gather`` calls made inside this
    context (every cross-rank move of the port is one), those made while
    the current stream captures apart: at one rank NCCL runs an
    all-gather as a device copy, no kernel of its own names it in a
    replay, so the captured calls show that the graph holds them."""
    import torch
    import torch.distributed as dist
    seen = {"eager": 0, "captured": 0}
    real = dist.all_gather

    def counted(*a, **kw):
        seen["captured" if torch.cuda.is_current_stream_capturing()
             else "eager"] += 1
        return real(*a, **kw)

    dist.all_gather = counted
    try:
        yield seen
    finally:
        dist.all_gather = real


def _copies(rows: list) -> int:
    """The device copies a profiled replay ran (a captured copy runs as a
    ``memcpy32_post`` kernel)."""
    return sum(r["count"] for r in rows if "memcpy" in r["name"].lower())


def _rank_rows(run) -> list:
    """Device time by kernel over one profiled call of ``run``: exactly
    one call, so every rank makes the same collectives (device_rows may
    call again after a miss); an empty list when the profiler missed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if dev and getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            rows.append({"name": e.key[:80], "count": e.count,
                         "device_us": float(dev)})
    return sorted(rows, key=lambda r: -r["device_us"])


def _rank_walls(run) -> dict:
    """REQUESTS timed calls after a warm one and one profiled call, the
    same calls on every rank."""
    import numpy as np
    run()
    walls = [_timed(run) for _ in range(REQUESTS)]
    rows = _rank_rows(run)
    dev = sum(r["device_us"] for r in rows) / 1e3 if rows else None
    return {"wall_ms": walls, "median_ms": float(np.median(walls)),
            "device_ms": dev, "idle": None if dev is None else
            1.0 - dev / float(np.median(walls)), "profile": rows[:8],
            "nccl": _nccl_rows(rows)}


def rank_train(rank: int, world: int, layers, jit: bool) -> dict:
    """One rank of the sharded mamba2-780m trainer on the 4 x 2 rank mesh:
    RANK_STEPS steps (captured with ``jit``) from the seeded state, then,
    with ``jit``, the same steps eager on the rank mesh, both held shard
    by shard; rank 0 runs the single-process step on its card and holds
    the rank run's gathered state, loss and metrics to it bit for bit;
    then RANK_WALLS more steps timed and one profiled."""
    import dataclasses

    import numpy as np
    import torch
    _rank_setup()
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_debug_mesh, rank_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    cfg = get_config("mamba2-780m")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    B, S = MESH_TRAIN_BATCH
    source = SyntheticLM(cfg, DataConfig(seq_len=S, global_batch=B, seed=SEED,
                                         mask_boundaries=False))
    batches = [source.batch(i) for i in range(RANK_STEPS + RANK_WALLS + 1)]
    oc = opt.OptConfig()
    p0 = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    from repro_torch.distributed.plan import MeshSpec
    spec, axes = MESH_SHAPE
    mesh = rank_mesh(MeshSpec(tuple(zip(axes, spec))))
    if any(d.type != "cuda" for d in mesh.devices):
        fail(f"rank {rank}: the rank mesh is not on the card: {mesh!r}")
    out = {"rank": rank, "world": world, "layers": cfg.n_layers,
           "device": torch.cuda.get_device_name(), "jit": jit}

    def steps(m, jit):
        sh = tl.train_state_shardings(p0, m, cfg)
        ps, ss = place(p0, sh["params"]), place(opt.adamw_init(p0), sh["opt"])
        step = tl.jit_train_step(cfg, m, p0, batches[0], oc, jit=jit)
        losses, walls = [], []
        for i in range(RANK_STEPS):
            walls.append(_timed(lambda i=i: losses.append(
                float(step(ps, ss, batches[i])[2]["loss"]))))
        return step, {"p": ps, "m": ss["m"], "v": ss["v"],
                      "step": ss["step"]}, losses, walls

    torch.cuda.reset_peak_memory_stats()
    with counting_all_gathers() as gathers:
        step, state, losses, walls = steps(mesh, jit)
    out["all_gathers"] = gathers
    out.update(losses=losses, first_walls_ms=walls,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               graphs=step.runner.program.graphs()
               if step.runner.program is not None else 0)
    leaves = _tree_paths(state)
    if jit:
        _, eager, losses_e, _ = steps(mesh, False)
        differ = [k for k, a in _tree_paths(eager).items()
                  if not all(torch.equal(x, y) for x, y in zip(
                      a.local_shards().values(),
                      leaves[k].local_shards().values()))]
        out["eager_bit_for_bit"] = not differ and losses_e == losses
        out["eager_differ"] = differ[:4]
        del eager
        torch.cuda.empty_cache()
    single = one_step = None
    if rank == 0:
        one_step, single, losses_1, _ = steps(
            make_debug_mesh(spec, axes), jit)
        out["single_losses"] = losses_1
    differ = []
    for k, a in leaves.items():          # every rank: a collective
        whole = a.gather()
        if single is not None and not torch.equal(whole,
                                                  single_whole(single, k)):
            differ.append(k)
        del whole
    if rank == 0:
        out["single_bit_for_bit"] = (not differ
                                     and out["single_losses"] == losses)
        out["single_differ"] = differ[:4]
        if one_step.runner.program is not None:
            one_step.runner.program.release()
        single = one_step = None
        torch.cuda.empty_cache()
    out["leaves"] = len(leaves)
    replays = []
    for j in range(RANK_WALLS):
        replays.append(_timed(lambda j=j: float(step(
            *_state_args(state), batches[RANK_STEPS + j])[2]["loss"])))
    rows = _rank_rows(lambda: step(*_state_args(state), batches[-1]))
    out.update(replay_walls_ms=replays,
               replay_median_ms=float(np.median(replays)),
               device_ms=sum(r["device_us"] for r in rows) / 1e3 if rows
               else None, nccl=_nccl_rows(rows), copies=_copies(rows),
               profile=rows[:8])
    return out


def single_whole(tree: dict, path: str):
    return _tree_paths(tree)[path].gather()


def _state_args(state: dict) -> tuple:
    return state["p"], {"m": state["m"], "v": state["v"],
                        "step": state["step"]}


def rank_program(rank: int, world: int) -> dict:
    """One rank of gpt2_block (RANK_PROGRAM_S, 1024) on the 4 x 2 rank
    mesh with jit=True, for each of RANK_PROGRAM_STRATEGIES: verify(), a
    first call (eager, then the capture) and a replay bit for bit the
    single-process program's (jit=True, the same seeded weights and
    input), the kernels the rank launched in the replays, NCCL in a
    profiled replay, and request walls both ways."""
    import numpy as np
    import torch
    _rank_setup()
    import codo_torch
    from repro_torch.launch.mesh import make_debug_mesh, rank_mesh
    from repro_torch.models.dataflow_models import gpt2_block_fn
    from repro_torch.distributed.plan import MeshSpec
    spec, axes = SHARD_MESH
    mesh = rank_mesh(MeshSpec(tuple(zip(axes, spec))))
    S = RANK_PROGRAM_S
    out = {"rank": rank, "world": world, "S": S, "strategies": {}}
    for strategy in RANK_PROGRAM_STRATEGIES:
        rng = np.random.default_rng(SEED + 330)
        made = {}
        for name, m in (("ranks", mesh),
                        ("single", make_debug_mesh(spec, axes))):
            made[name] = codo_torch.compile(gpt2_block_fn, (S, D_MODEL),
                                            mesh=m,
                                            sharding_strategy=strategy)
        weights = seeded_weights(made["ranks"].graph, rng)
        x = torch.as_tensor(rng.standard_normal((S, D_MODEL))
                            .astype(np.float32), device="cuda")
        for program in made.values():
            program.bind(**{k: torch.as_tensor(v, device="cuda")
                            for k, v in weights.items()})
        ours, single = made["ranks"], made["single"]
        ours.verify(x)
        with counting_all_gathers() as gathers:
            first = ours(x)
        torch.cuda.synchronize()
        zero_counts()
        replays = [ours(x) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
        want = single(x)
        bits = all(torch.equal(y, want) for y in [first, *replays])
        timing = {"ranks": _rank_walls(lambda: ours(x)),
                  "single": _rank_walls(lambda: single(x))}
        out["strategies"][strategy] = {
            "resolved": ours.sharding.strategy,
            "digest": ours.sharding.digest(),
            "vias": sorted({(s.kind, s.via) for s in ours.sharding.steps}),
            "verify": True, "bit_for_bit": bits, "launches": launches,
            "graphs": ours.lower(jit=True).fn.graphs(),
            "all_gathers": gathers, "nccl": timing["ranks"]["nccl"],
            "request": timing}
    return out


def rank_one(rank: int, world: int) -> dict:
    """(a) then (b) in one process a rank: the trainer's graphs released
    before the program's."""
    import torch
    train = rank_train(rank, world, None, True)
    from repro_torch.core.capture import clear_graphs
    clear_graphs()
    torch.cuda.empty_cache()
    return {"train": train, "program": rank_program(rank, world)}


def _in_the_graph(world: int, gathers: dict, nccl: list, profile: list,
                  label: str) -> None:
    """Fail unless the captured step holds its NCCL collectives: the
    all-gathers made while capturing, and across ranks NCCL's kernels in
    the profiled replay too (at one rank NCCL's all-gather is a device
    copy); a line says so where the profiler missed."""
    if not gathers["captured"]:
        fail(f"{label}: no all-gather captured ({gathers})")
    if world == 1:
        return
    if not profile:
        print(f"  {label}: NCCL kernels in the replay not checked (the "
              f"profiler saw no device time); {gathers['captured']} "
              f"all-gathers captured")
    elif not nccl:
        fail(f"{label}: no NCCL kernel in the profiled replay "
             f"{[r['name'] for r in profile]}")


def _rank_checks(label: str, run: dict, record: list, nccl: bool) -> None:
    """Fail unless the rank trainer's steps were bit for bit (captured ones
    against eager too), with its NCCL collectives in the graph."""
    ok = run.get("single_bit_for_bit", True)
    if run["jit"]:
        ok = ok and run["eager_bit_for_bit"] and run["graphs"] == 1
    if nccl:
        _in_the_graph(run["world"], run["all_gathers"], run["nccl"],
                      run["profile"], label)
    if not ok:
        fail(f"{label}: not bit for bit: {run}")
    record.append({"case": label, "bit_for_bit": True, "ok": True})


def _train_line(label: str, run: dict, card: str) -> str:
    nccl = sum(r["device_us"] for r in run["nccl"]) / 1e3
    device = ("device not measured (the profiler missed)"
              if run["device_ms"] is None else
              f"device {run['device_ms']:.3f} ms, NCCL {nccl:.3f} ms in "
              f"{sum(r['count'] for r in run['nccl'])} kernels "
              f"{sorted({r['name'][:40] for r in run['nccl']})}, "
              f"{run['copies']} device copies")
    return (f"  {label}: losses {run['losses']} bit for bit the "
            f"single-process step's"
            + (" and its own eager run's" if run["jit"] else "")
            + f"; all-gathers {run['all_gathers']} (eager first step, then "
            f"captured); {card}: steps {run['replay_median_ms']:.3f} ms "
            f"(median of "
            f"{RANK_WALLS}; first {run['first_walls_ms'][0]:.1f} ms), "
            f"{device}; peak {run['peak_gib']:.2f} GiB")


def _program_checks(label: str, run: dict, record: list, card: str) -> None:
    for strategy, r in run["strategies"].items():
        want = {"mmchain"} | ({"flash"} if r["resolved"] == "replicate"
                              else set())
        if not r["bit_for_bit"] or r["graphs"] != 1 or not want <= set(
                r["launches"]):
            fail(f"{label} {strategy}: {r}")
        _in_the_graph(run["world"], r["all_gathers"], r["nccl"],
                      r["request"]["ranks"]["profile"],
                      f"{label} {strategy}")
        req = r["request"]
        print(f"  {label} gpt2_block ({run['S']}, {D_MODEL}) {strategy}: "
              f"verify ok, bit for bit the single-process program, one "
              f"graph, launches {r['launches']} in {REQUESTS} replays, "
              f"collectives {r['vias']}, all-gathers {r['all_gathers']} "
              f"(eager first call, then captured), NCCL kernels "
              f"{sum(x['count'] for x in r['nccl'])}; {card}: request "
              f"{wall_text(req['ranks'])} against single-process "
              f"{wall_text(req['single'])}")
        record.append({"case": f"{label} gpt2_block {strategy}",
                       "bit_for_bit": True, "ok": True})


def rank_phase(card: str, record: dict, mesh_train_run: dict) -> dict:
    """(a)-(d) of the rank phase (see above RANK_STEPS)."""
    import torch

    from repro_torch.core.capture import clear_graphs
    from repro_torch.launch import ranks
    clear_graphs()
    torch.cuda.empty_cache()
    checks = record["checks"]
    print(f"card: {card}")
    out = {}
    t = time.perf_counter()
    (one,) = ranks.spawn(rank_one, 1, timeout_s=RANK_TIMEOUT)
    out["one_rank_s"] = time.perf_counter() - t
    _rank_checks("(a) one NCCL rank, mamba2-780m 4x2", one["train"], checks,
                 nccl=True)
    print(_train_line("(a) one NCCL rank, mamba2-780m 4x2 full depth",
                      one["train"], card)
          + f"; the single-process step in mesh_train "
          f"{mesh_train_run['replay_median_ms']:.3f} ms (device "
          f"{mesh_train_run['device_ms']:.3f})")
    _program_checks("(b) one NCCL rank", one["program"], checks, card)
    out["one"] = one
    t = time.perf_counter()
    gloo = ranks.spawn(rank_train, 2, RANK_GLOO_LAYERS, False,
                       backend="gloo", timeout_s=RANK_TIMEOUT)
    out["gloo_s"] = time.perf_counter() - t
    label = (f"(c) two gloo ranks on one card, mamba2-780m 4x2 "
             f"{RANK_GLOO_LAYERS} layers, eager")
    for run in gloo:
        _rank_checks(label, run, checks, nccl=False)
    print(_train_line(label + " (rank 0)", gloo[0], card))
    out["gloo"] = gloo
    out["cards"] = rank_cards(card, checks)
    return out


def rank_cards(card: str, checks: list) -> dict:
    """(d): with two cards or more, (a) and (b) over min(count, 4) NCCL
    ranks, one a card; otherwise one line saying it did not run."""
    import torch

    from repro_torch.launch import ranks
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"  (d) NCCL over several cards: not run, this host has "
              f"{cards} card")
        return {"ran": False, "count": cards}
    n = min(cards, 4)
    t = time.perf_counter()
    many = ranks.spawn(rank_one, n, timeout_s=RANK_TIMEOUT)
    wall = time.perf_counter() - t
    for run in many:
        _rank_checks(f"(d) {n} NCCL ranks, mamba2-780m 4x2", run["train"],
                     checks, nccl=True)
        _program_checks(f"(d) {n} NCCL ranks", run["program"], checks, card)
    print(_train_line(f"(d) {n} NCCL ranks on {n} cards, mamba2-780m 4x2 "
                      f"(rank 0)", many[0]["train"], card))
    return {"ran": True, "count": cards, "ranks": many, "wall_s": wall}


# The launch phase.  (a) the API smoke CLI's workloads and the kernel each
# must launch in process under forced routing: multi_head_attention's
# chains route streamfuse.mmchain in both packages (no Table II workload
# routes flashattn.mha), so flash_attention is not on this path; (b)
# pad_conv_relu at ResNet-18's N=8 64 x 56² route and VGG-16's first chain
# (N, C, H, CO); (c) the five examples and the verdict line each prints,
# at small step counts; (d) the production cell the dry-run costs; each
# subprocess's time limit.
LAUNCH_API = {"feed_forward": "mmchain", "multi_head_attention": "mmchain",
              "conv3_block": "conv"}
LAUNCH_CONV = [(8, 64, 56, 64), (1, 3, 224, 64)]
LAUNCH_EXAMPLES = {
    "quickstart": ([], "compiled(x) == motivating(x) == oracle ✓"),
    "compile_resnet18": (["--cache-dir", "build/launch/resnet18_cache"],
                         "reloaded design executed on cuda"),
    "pipeline_parallel": ([], "pipeline vs serial max err:"),
    "serve_lm": ([], "8/8 finished;"),
    "train_lm": (["--steps", "30", "--ckpt", "build/launch/train_lm_ckpt"],
                 "arch=gpt2-medium-smoke steps=30 loss"),
}
LAUNCH_CELL = ("mamba2-780m", "train_4k", "single")
LAUNCH_TIMEOUT = 300


class _Spawned:
    """A subprocess of the launch phase, its output in a file under
    ``build/launch/``; a thread notes when it ends, so its wall is its own
    whenever it is read.  It leads a process group of its own, so a kill
    stops the processes it started too (perf's dry-runs)."""

    def __init__(self, name: str, argv: list, env: dict):
        import threading
        self.name = name
        log_dir = ROOT / "build" / "launch"
        log_dir.mkdir(parents=True, exist_ok=True)
        self.log = log_dir / f"{name}.log"
        self._fh = self.log.open("w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=self._fh,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
        self.wall_s = None
        self._watch = threading.Thread(target=self._ended, daemon=True)
        self._watch.start()

    def _ended(self) -> None:
        self.proc.wait()
        self.wall_s = time.perf_counter() - self.t0

    def finish(self) -> str:
        """Wait (at most LAUNCH_TIMEOUT s), then its output; fails on a
        non-zero exit."""
        self._watch.join(timeout=LAUNCH_TIMEOUT)
        if self._watch.is_alive():
            self.kill()
            fail(f"launch: {self.name} ran past {LAUNCH_TIMEOUT} s")
        rc = self.proc.returncode
        self._fh.close()
        text = self.log.read_text()
        if rc != 0:
            fail(f"launch: {self.name} exited {rc}:\n{text[-3000:]}")
        return text

    def kill(self) -> None:
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:        # the group has ended
            pass
        self.proc.wait()
        self._fh.close()


def _launch_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    return env


def _api_argv(workload: str, cache: Path) -> list:
    return [sys.executable, "-m", "repro_torch.api", workload, "--run",
            "--cache-dir", str(cache)]


def _api_line(name: str, text: str) -> dict:
    """The ``cache_hit=`` / ``speedup=`` / ``key=`` line of one API run and
    whether it verified on the card."""
    m = re.search(r"cache_hit=(\w+) speedup=([\d.]+)x key=(\w{12})", text)
    if not m:
        fail(f"launch: {name} printed no cache_hit= / key= line")
    verified = "numerics verified against the oracle" in text and (
        "on cuda" in text)
    if not verified:
        fail(f"launch: {name} did not verify its numerics on the card")
    return {"cache_hit": m.group(1) == "True", "speedup": float(m.group(2)),
            "key": m.group(3)}


def launch_api_in_process() -> dict:
    """(a) ``api.main`` of each LAUNCH_API workload with ``--run`` in this
    process (forced routing), the launch counters zeroed just before and
    read just after each: the workload's kernel must launch."""
    import io

    from repro_torch import api
    out = {}
    for w, key in LAUNCH_API.items():
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = api.main([w, "--run"])
        launched = {k: n for k, n in counts().items() if n}
        if rc != 0 or "numerics verified" not in text.getvalue():
            fail(f"launch: api.main({w!r}) did not verify on the card")
        if not launched.get(key):
            fail(f"launch: api.main({w!r}) launched no {key} kernel "
                 f"({launched})")
        out[w] = launched
        print(f"  (a) api.main([{w!r}, '--run']) in process: launches "
              f"{launched}")
    return out


def launch_conv(card: str, record: list) -> dict:
    """(b) ``pad_conv_relu(use_kernel=True)`` on the card at LAUNCH_CONV
    against ``use_kernel=False``: within CONV_TOL of scale, one conv
    launch a call, event and device times beside cuDNN's (full float32)
    and the bounds."""
    import torch
    from repro_torch.core.ops import full_f32_convolutions
    from repro_torch.kernels.streamfuse import (CONV_LIBRARY,
                                                pad_conv_relu_plain)
    from repro_torch.kernels.streamfuse.ops import pad_conv_relu
    g = torch.Generator(device="cuda").manual_seed(SEED + 700)
    out = {}
    for N, C, H, CO in LAUNCH_CONV:
        name = f"{N}x{C}x{H}x{H}->{CO}"
        x, w = conv_operands(N, C, H, H, CO, 3, g)
        CONV_LIBRARY.reset_counts()
        got = pad_conv_relu(x, w, use_kernel=True)
        torch.cuda.synchronize()
        calls = CONV_LIBRARY.entry_launches["codo_pad_conv_relu"]
        if calls != 1:
            fail(f"launch: pad_conv_relu {name} made {calls} conv launches")
        want = pad_conv_relu(x, w, use_kernel=False)
        err = check_scaled(record, f"pad_conv_relu {name} use_kernel",
                           got, want, CONV_TOL)
        iters = 20

        def library():
            with full_f32_convolutions():
                return torch.relu(torch.nn.functional.conv2d(x, w, padding=1))

        ms, plain = in_turns(lambda: pad_conv_relu_plain(x, w),
                             lambda: pad_conv_relu(x, w), iters)
        m = {"ms": ms, "plain_ms": plain,
             "library_ms": time_ms(library, iters),
             "device_ms": device_ms(lambda: pad_conv_relu(x, w), iters),
             "max_abs_err": err, "launches": 1,
             "flops": 2.0 * N * H * H * CO * C * 9,
             "bytes": 4.0 * (N * C * H * H + CO * C * 9 + N * CO * H * H)}
        m.update(tf32x3_bound(m["flops"], m["bytes"]))
        out[name] = m
        print(f"  (b) {card}: pad_conv_relu {name}: kernel {ms:.4f} ms "
              f"(device {m['device_ms']:.4f})  plain {plain:.4f}  cuDNN "
              f"{m['library_ms']:.4f}  {bound_text(m)}")
    return out


def launch_dryrun_mesh(card: str, mesh_train_run: dict) -> dict:
    """(d) The mesh phase's (a) configuration costed by the dry-run on a
    4 x 2 mesh of meta positions: a position's parameter and optimizer
    bytes must equal what the mesh phase measured a position; the
    predicted peaks beside the measured one; FLOPs a step over the
    measured replay wall."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    (shape, axes), (B, S) = MESH_SHAPE, MESH_TRAIN_BATCH
    t0 = time.perf_counter()
    rec = dryrun.run_cell("mamba2-780m", "mesh_phase", "4x2",
                          mesh=dryrun.meta_mesh(shape, axes),
                          shape=ShapeSpec("mesh_phase", S, B, "train"),
                          accum=MESH_ACCUM)
    wall = time.perf_counter() - t0
    if rec["status"] != "ok":
        fail(f"launch: the dry-run of the mesh phase's cell: "
             f"{rec.get('error')}\n{rec.get('traceback', '')}")
    mem = rec["memory"]
    state = mem["argument_parts"]["params"] + mem["argument_parts"]["opt"]
    held = mesh_train_run["held_bytes"][0]
    if state != held:
        fail(f"launch: the dry-run's state a position {state} B is not the "
             f"{held} B the mesh phase measured a position")
    step_ms = mesh_train_run["replay_median_ms"]
    tflops = rec["flops_one_device"] / (step_ms * 1e-3) / 1e12
    measured_gib = mesh_train_run["peak_memory_gib"]
    print(f"  (d) mesh phase's cell (mamba2-780m {MESH_TRAIN_BATCH}, 4x2, "
          f"accum {MESH_ACCUM}) on meta: state a position {state / 2**20:.1f}"
          f" MiB = measured {held / 2**20:.1f} MiB ✓ (argument bytes "
          f"{mem['argument_bytes'] / 2**20:.1f} MiB with the batch's shard);"
          f" walked in {wall:.1f} s")
    print(f"      predicted peak a position {mem['peak_per_device'] / 2**30:.2f}"
          f" GiB; every position on one card "
          f"{mem['one_device_peak'] / 2**30:.2f} GiB; measured on the card "
          f"{measured_gib:.2f} GiB")
    print(f"      flops_per_device {rec['flops_per_device']:.4e} (compute "
          f"split over model: replicated_model_compute "
          f"{rec['replicated_model_compute']}), collectives "
          f"{rec['collective']['total']:.4e} B a position")
    print(f"      {card}: {rec['flops_one_device']:.4e} FLOPs a step (the "
          f"card's, every position) / {step_ms:.3f} ms replay = "
          f"{tflops:.2f} TFLOP/s, {100 * tflops / 989:.2f} % of 989 "
          f"(bfloat16 dense)")
    return {"record": rec, "wall_s": wall, "state_bytes": state,
            "measured_state_bytes": held, "tflops": tflops,
            "measured_peak_gib": measured_gib}


def launch_phase(card: str, record: dict, mesh_train_run: dict) -> dict:
    """The port's last entry points on the card: (a) the API smoke CLI,
    (b) ``pad_conv_relu``, (c) the five examples, (d) the dry-run, (e)
    ``perf``.  Subprocesses run side by side; every one is stopped before
    this returns or fails."""
    import shutil
    print(f"card: {card}")
    checks = record["checks"]
    out = {"conv": launch_conv(card, checks)}   # timed before the others
    env = _launch_env()
    caches = ROOT / "build" / "launch" / "api_cache"
    shutil.rmtree(caches, ignore_errors=True)
    arch, shape, mesh_kind = LAUNCH_CELL
    running: list = []
    try:
        cold = {w: _Spawned(f"api_{w}_cold", _api_argv(w, caches / w), env)
                for w in LAUNCH_API}
        running += cold.values()
        examples = {
            name: _Spawned(f"example_{name}", [
                sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
                *args], env) for name, (args, _) in LAUNCH_EXAMPLES.items()}
        running += examples.values()
        cell_dir = ROOT / "build" / "launch" / "dryrun"
        cell = _Spawned("dryrun", [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape, "--mesh", mesh_kind, "--out", str(cell_dir),
            "--force"], env)
        perf = _Spawned("perf", [
            sys.executable, "-m", "repro_torch.launch.perf", "--arch", arch,
            "--shape", shape, "--mesh", mesh_kind, "--variant", "base",
            "--variant", "dots:REPRO_REMAT_POLICY=dots", "--out",
            str(ROOT / "build" / "launch" / "perf")], env)
        running += [cell, perf]

        api_runs = {}
        warm = {}
        for w, p in cold.items():
            api_runs[w] = {"cold": _api_line(p.name, p.finish()),
                           "cold_wall_s": p.wall_s}
            warm[w] = _Spawned(f"api_{w}_warm", _api_argv(w, caches / w),
                               env)
            running.append(warm[w])
        out["api_in_process"] = launch_api_in_process()
        for w, p in warm.items():
            run = api_runs[w]
            run["warm"] = _api_line(p.name, p.finish())
            run["warm_wall_s"] = p.wall_s
            if run["cold"]["cache_hit"] or not run["warm"]["cache_hit"]:
                fail(f"launch: {w}: cold cache_hit={run['cold']['cache_hit']}"
                     f", warm cache_hit={run['warm']['cache_hit']}")
            if run["cold"]["key"] != run["warm"]["key"]:
                fail(f"launch: {w}: the warm run's key is not the cold run's")
            print(f"  (a) python -m repro_torch.api {w} --run: cold "
                  f"cache_hit=False, warm cache_hit=True, key="
                  f"{run['cold']['key']} speedup={run['cold']['speedup']}x, "
                  f"verified on the card both times; walls "
                  f"{run['cold_wall_s']:.1f} / {run['warm_wall_s']:.1f} s")
        out["api"] = api_runs

        out["examples"] = {}
        for name, p in examples.items():
            text = p.finish()
            verdict = LAUNCH_EXAMPLES[name][1]
            line = next((ln for ln in text.splitlines() if verdict in ln),
                        None)
            if line is None:
                fail(f"launch: examples/torch/{name}.py printed no "
                     f"{verdict!r} line:\n{text[-2000:]}")
            out["examples"][name] = {"wall_s": p.wall_s, "verdict": line}
            print(f"  (c) {card}: examples/torch/{name}.py "
                  f"{' '.join(LAUNCH_EXAMPLES[name][0])} {p.wall_s:.1f} s: "
                  f"{line.strip()[:100]}")

        cell.finish()
        rec = json.loads((cell_dir / f"{arch}__{shape}__{mesh_kind}.json")
                         .read_text())
        if rec["status"] != "ok":
            fail(f"launch: the dry-run of {LAUNCH_CELL}: {rec['status']} "
                 f"{rec.get('error')}")
        print(f"  (d) dryrun {arch} {shape} {mesh_kind} ({rec['chips']} meta "
              f"positions, {rec['mesh_shape']}): status ok, "
              f"{rec['flops_per_device']:.4e} FLOPs / "
              f"{rec['bytes_per_device']:.4e} bytes a device, collectives "
              f"{rec['collective']['total']:.4e} B, peak "
              f"{rec['memory']['peak_per_device'] / 2**30:.2f} GiB; walked in "
              f"{rec['walk_s']} s, the subprocess {cell.wall_s:.1f} s")
        out["dryrun_cell"] = {k: rec[k] for k in (
            "status", "flops_per_device", "bytes_per_device",
            "transcendentals", "collective", "memory", "model_flops",
            "chips", "mesh_shape", "walk_s", "wall_s", "ops")}
        out["dryrun_cell"]["subprocess_s"] = cell.wall_s
        out["dryrun_mesh"] = launch_dryrun_mesh(card, mesh_train_run)

        text = perf.finish()
        rows = [ln for ln in text.splitlines()
                if ln.startswith(("base ", "dots "))]
        if len(rows) != 2:
            fail(f"launch: perf printed {len(rows)} of its two rows:\n"
                 f"{text[-2000:]}")
        for ln in rows:
            print(f"  (e) perf {ln}")
        out["perf"] = {"rows": rows, "wall_s": perf.wall_s}
    finally:
        for p in running:
            p.kill()
    return out


def _ssd_local_shape() -> tuple:
    """ssd_chunk_scan's (chunks, batch x heads, head dim, state) in the
    sharded trainer: a data block's rows of MESH_TRAIN_BATCH, a model
    position's heads."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-780m")
    s = cfg.ssm
    rows = MESH_TRAIN_BATCH[0] // MESH_SHAPE[0][0]
    heads = cfg.d_model * s.expand // s.head_dim // MESH_SHAPE[0][1]
    return (MESH_TRAIN_BATCH[1] // s.chunk, rows * heads, s.head_dim,
            s.d_state)


def no_fallback() -> dict:
    """A step that reads a device value on the host cannot be captured:
    the first jit=True call raises CaptureError naming the step, and no
    graph is kept.  Run last: a failed capture is the end of that
    capture."""
    import torch

    from repro_torch.core.capture import (CaptureError, CapturedProgram,
                                          graph_count)

    def host_read(scope):
        return {"y": scope["x"] * float(scope["x"].sum())}

    program = CapturedProgram([("host_read", host_read)], ["y"])
    before = graph_count()
    try:
        program({"x": torch.ones(4, device="cuda")})
    except CaptureError as e:
        message = str(e)
    else:
        fail("capture: a host read inside a captured step did not raise")
    if "host_read" not in message or graph_count() != before:
        fail(f"capture: the error does not name the step, or a graph was "
             f"kept: {message}")
    print(f"  a step reading a device value on the host: {message[:160]}")
    return {"message": message}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    for var in ("CODO_DISABLE_PALLAS", "CODO_BACKEND", "CODO_TUNING_DB"):
        os.environ.pop(var, None)
    # Every path and kernel check runs under forced routing, so every
    # kernel launches whatever the fitted gate decides; the routing fit
    # asserts the default gate's plans.
    os.environ["CODO_FORCE_PALLAS"] = "1"
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the card")
    # cuBLAS float32 matmuls in full float32 (PyTorch's default, stated);
    # cuDNN's TF32 flag stays at its default: the conv2d body and the
    # oracle turn it off for their own calls (check_conv_precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    record: dict = {"checks": []}

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import common
    libs = all_libraries()
    build_s = common.build_all(list(libs.values()))
    print(f"build: {build_s:.1f} s for {len(libs)} kernels (nvcc, parallel)")
    record["ptxas"] = {}
    for lib in libs.values():
        lines = [line.strip() for line in lib.build_log.splitlines()
                 if "registers" in line or "spill" in line
                 or "Compiling entry" in line]
        record["ptxas"][lib.source.name] = lines
        for line in lines:
            # A kernel's mangled name from its name and first template
            # arguments on: enough to tell the instantiations apart (the
            # conv's tile shape spelled out, its promotion flag after it).
            line = re.sub(r"N13codo_gemm_mma9TileShapeI((?:Li\d+E)+)EE",
                          lambda m: "<" + ",".join(re.findall(
                              r"Li(\d+)E", m.group(1))) + ">", line)
            entry = re.search(r"[a-z_]+_kernel[\w<>,]{0,40}", line)
            if "Compiling entry" in line and entry:
                line = f"entry {entry.group(0)}"
            print(f"  {lib.source.name}: {line}")
    record["build_s"] = build_s
    record["sass_mma"] = tensor_core_sass(libs)

    print("kernels against their plain versions:")
    check_flash(record["checks"])
    check_chain(record["checks"])
    check_grad(record["checks"])
    check_precision(record)
    check_conv(record["checks"])
    check_conv_precision(record)
    check_slice(record["checks"])
    measured = {}
    for S in SEQS:
        measured[S] = measure_kernels(S, record)
    record["measured"] = {str(s): m for s, m in measured.items()}
    cnn_cases = [("resnet18", N, RESNET_ROUTES) for N in CNN_BATCHES]
    cnn_cases.append(("vgg16", 1, VGG_ROUTES))
    conv_measured = {(m, N): measure_conv(N, routes, record)
                     for m, N, routes in cnn_cases}
    head = measure_head(record)
    record["measured_conv"] = {f"{m} N={N}": v
                               for (m, N), v in conv_measured.items()}
    record["measured_vgg16_head"] = head
    print("slice kernels at their route shapes:")
    slice_measured = measure_slice(record)
    record["measured_slice"] = slice_measured

    print("main path: codo_torch.compile(gpt2_block_fn, (S, 1024)):")
    runs = {S: main_path(S, record) for S in SEQS}
    record["main_path"] = {str(s): r for s, r in runs.items()}
    print("train path: codo_torch.compile(gpt2_block_loss_fn, (S, 1024), "
          "(S, 1024), grad=True):")
    trains = {S: train_path(S) for S in SEQS}
    record["train_path"] = {str(s): r for s, r in trains.items()}
    print(f"CNN path: codo_torch.compile(<model>_fn, (N, 3, {IMAGE}, "
          f"{IMAGE})):")
    cnns = {(m, N): cnn_path(m, N, routes) for m, N, routes in cnn_cases}
    record["cnn_path"] = {f"{m} N={N}": r for (m, N), r in cnns.items()}
    print("recurrence and attention-tail paths: codo_torch.compile(<fn>, "
          "*shapes):")
    slices = {w[0]: slice_path(SEED + 50 + i, *w)
              for i, w in enumerate(slice_workloads())}
    record["slice_path"] = slices
    print("the blocked matmul through ops.mm:")
    mm_run = mm_path()
    record["mm_path"] = mm_run
    print("train paths of the slice: codo_torch.compile(<loss>, *shapes, "
          "grad=True[, wrt=...]):")
    train_slices = {w[0]: slice_train_path(SEED + 80 + i, *w)
                    for i, w in enumerate(train_workloads())}
    record["train_slice_path"] = train_slices
    print("artifacts: export, then codo_torch.load on the card:")
    record["reload_path"] = reload_path()
    print("routing fit: autotune every path (a private TuningDB), the "
          "fitted gate, each path's default-gate plan:")
    record["routing_fit"] = routing_fit()
    print("serving: the runtime on the card (forced routing):")
    serving_flash = measure_serving_flash(record)
    record["measured_serving_flash"] = serving_flash
    with eager_programs():
        serving = serving_path()
    record["serving_path"] = serving
    print("capture: jit=True (CUDA graphs) against jit=False on the card "
          "(forced routing):")
    record["capture_path"] = capture_path(serving)
    print("the batch driver: codo_opt_batch, then each cell on the card "
          "with jit=True:")
    record["compiler_phase"] = compiler_phase()
    print("sharding: gpt2_block on a 4x2 mesh of positions on the card "
          "(forced routing):")
    sharding = sharding_phase(card, record)
    record["sharding_phase"] = sharding
    print("the LM serving stack: repro_torch.models, the Generator's "
          "captured decode step, serve --arch:")
    lm = lm_phase(card, record)
    record["lm_phase"] = lm
    print("LM training: repro_torch.training (AdamW, the captured train "
          "step, the CLI, checkpoints), the scans' backwards:")
    train = train_phase(card, record, TRAIN_STEPS * trains[SEQS[0]][
        "launches_per_step"])
    record["train_phase"] = train
    print("the LM stack on a mesh: jit_train_step, jit_prefill_step, "
          "jit_serve_step, the elastic restart and compressed_allreduce on a "
          "4x2 mesh of positions on the card:")
    mesh = mesh_phase(card, record)
    record["mesh_phase"] = mesh
    print("the mesh over ranks, one process a card (launch/ranks.py: spawn, "
          "launch/mesh.py: rank_mesh):")
    record["rank_phase"] = rank_phase(card, record, mesh["train"])
    print("the launch entry points: the API smoke CLI, pad_conv_relu, the "
          "examples, the dry-run over meta positions and perf:")
    launch = launch_phase(card, record, mesh["train"])
    record["launch_phase"] = launch
    print("no fallback:")
    record["no_fallback"] = no_fallback()
    record["profiler_misses"] = PROFILER_MISSES
    print(f"profiler: {len(PROFILER_MISSES)} profiled call(s) recorded no "
          f"device time and were timed with CUDA events"
          + "".join(f"; {m['caller']} {m['events_us']:.1f} us"
                    for m in PROFILER_MISSES))

    # One entry a kernel and S.  fused_matmul_grad's serves both backward
    # chains, and its launch counter counts both: its entry carries that
    # count, and the chains' times, bounds and yardsticks summed (one
    # call of each is the kernel's work in a step); each chain's own
    # numbers are in the record.
    source = {"flash": ("flash_attention", "src/repro_torch/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn/flashattn.py:96"),
              "mmchain": ("fused_matmul_chain", "src/repro_torch/csrc/chain.cu",
                          "src/repro/kernels/streamfuse/chain.py:79"),
              "mmgrad": ("fused_matmul_grad",
                         "src/repro_torch/csrc/chain_grad.cu",
                         "src/repro/kernels/streamfuse/chain.py:125")}
    entries = []
    for S in SEQS:
        for key, (fn, src, replaces) in source.items():
            if key == "mmgrad":
                parts = [measured[S][f"mmgrad_{c}"] for c in ("ffn", "attn")]
                m = {k: sum(p[k] for p in parts) for k in
                     ("ms", "plain_ms", "library_ms", "flops", "bytes")}
                m["max_abs_err"] = max(p["max_abs_err"] for p in parts)
                m.update(tf32x3_bound(m["flops"], m["bytes"]))
                launches = trains[S]["launches"]["mmgrad"]
            else:
                m, launches = measured[S][key], runs[S]["launches"][key]
            entries.append({
                "name": f"{fn}[S={S}]", "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                **f32_bound(m)})
    conv_src = ("src/repro_torch/csrc/pad_conv_relu.cu",
                "src/repro/kernels/streamfuse/streamfuse.py:58")
    cnn_entries = [(f"fused_pad_conv_relu[{m} N={N}]", *conv_src,
                    conv_measured[(m, N)], cnns[(m, N)]["launches"]["conv"])
                   for m, N, _ in cnn_cases]
    cnn_entries.append(("fused_matmul_chain[vgg16 N=1 head]",
                        *source["mmchain"][1:], head,
                        cnns[("vgg16", 1)]["launches"]["mmchain"]))
    tails = [f"{M}x{K}x{N}" for M, K, N in TAIL_SHAPES]
    cnn_entries += [
        ("rglru_scan[rglru_block " + "x".join(map(str, RGLRU_SHAPE)) + "]",
         "src/repro_torch/csrc/rglru_scan.cu",
         "src/repro/kernels/rglru/rglru.py:49", slice_measured["rglru"],
         slices["rglru_block"]["kernel_launches"]),
        ("ssd_chunk_scan[ssd_block " + "x".join(map(str, SSD_SHAPE)) + "]",
         "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd/ssd.py:45", slice_measured["ssd"],
         slices["ssd_block"]["kernel_launches"]),
        # The train steps' forwards run the same scans at the same shapes:
        # the same measurements, the train paths' launches.
        ("rglru_scan[rglru_block train step "
         + "x".join(map(str, RGLRU_SHAPE)) + "]",
         "src/repro_torch/csrc/rglru_scan.cu",
         "src/repro/kernels/rglru/rglru.py:49", slice_measured["rglru"],
         train_slices["rglru_block"]["kernel_launches"]),
        ("ssd_chunk_scan[ssd_block train step "
         + "x".join(map(str, SSD_SHAPE)) + "]",
         "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd/ssd.py:45", slice_measured["ssd"],
         train_slices["ssd_block"]["entry_launches"].get(
             "codo_ssd_chunk_scan", 0)),
        # Its grad op's reverse kernel, measured at the same shape by the
        # train phase's ssd_shapes.
        ("ssd_chunk_scan_backward[ssd_block train step "
         + "x".join(map(str, SSD_SHAPE)) + "]",
         "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd/ssd.py:45",
         train["ssd_shapes"]["x".join(map(str, SSD_SHAPE))]["backward"],
         train_slices["ssd_block"]["entry_launches"].get(
             "codo_ssd_chunk_scan_backward", 0)),
        ("flash_attention[mha_batched " + "x".join(map(str, MHA_SHAPE)) + "]",
         *source["flash"][1:], slice_measured["flash_mha"],
         slices["mha_batched"]["kernel_launches"])]
    cnn_entries += [
        (f"fused_softmax_matmul[attention_tail {t}]",
         "src/repro_torch/csrc/softmax_mm.cu",
         "src/repro/kernels/streamfuse/chain.py:185",
         slice_measured[f"softmaxmm_{t}"],
         slices[f"attention_tail {t}"]["kernel_launches"]) for t in tails]
    cnn_entries.append((
        f"flash_attention[serving batch {SERVE_BATCH}x{SERVE_S}x{D_MODEL}]",
        *source["flash"][1:], serving_flash,
        serving["batched"]["flash_launches"]))
    # The chain at the local shapes of the sharded phase: its launches in
    # the REQUESTS counted requests of the first strategy that gave it.
    for key, m in sharding["chain_local"].items():
        strategy, S = m["strategies"][0].split(" S=")
        launches = sharding["paths"][S]["strategies"][strategy]["launches"]
        cnn_entries.append((
            f"fused_matmul_chain[sharded {m['strategies'][0]} {key}]",
            *source["mmchain"][1:], m, launches["mmchain"]))
    # The LM phase's scans at the full-width models' shapes: the first
    # launch of each kind measured (a model's launches share one shape),
    # the launches of its counted prefill.
    scan_src = {"rglru": ("rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
                          "src/repro/kernels/rglru/rglru.py:49"),
                "ssd": ("ssd_chunk_scan", "src/repro_torch/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd/ssd.py:45")}
    for arch, run in lm["wide"].items():
        for kind, n in run["launches"].items():
            m = next(v for v in run["kernels"].values() if v["kind"] == kind)
            fn, src, replaces = scan_src[kind]
            cnn_entries.append((
                f"{fn}[{arch} prefill " + "x".join(map(str, m["shape"]))
                + "]", src, replaces, m, n))
    # The train phase's scans at the trainers' shapes: the forward (its
    # launches in the trainer's forward and remat passes) and the backward
    # helper (one reverse launch with its flips and products; its launches
    # in the backward pass, one a recurrent block a step).
    for kind, trainer in (("rglru", "recurrentgemma-9b x3"),
                          ("ssd", "mamba2-780m")):
        fn, src, replaces = scan_src[kind]
        run, m = train["trainer"][trainer], train["scans"][kind]
        bwd = run["backward_per_step"][kind] * run["steps"]
        shape = "x".join(map(str, m["shape"]))
        cnn_entries += [
            (f"{fn}[{trainer} trainer forward {shape}]", src, replaces,
             m["forward"], run["launches"][kind] - bwd),
            (f"{fn}_backward[{trainer} trainer {shape}]", src, replaces,
             m["backward"], bwd)]
    # The mesh phase's scans at their local shapes: the sharded trainer's
    # data blocks (forward and remat launches, then the backward helper's,
    # one a block and data block a step) and the sharded prefill's.
    m = mesh["ssd"]
    shape = "x".join(map(str, m["shape"]))
    fn, src, replaces = scan_src["ssd"]
    cnn_entries += [
        (f"{fn}[mamba2-780m 4x2 trainer forward {shape}]", src, replaces,
         m["forward"], mesh["train"]["ssd_forward"]),
        (f"{fn}_backward[mamba2-780m 4x2 trainer {shape}]", src, replaces,
         m["backward"], mesh["train"]["ssd_backward"])]
    m = mesh["prefill"]["rglru"]
    fn, src, replaces = scan_src["rglru"]
    cnn_entries.append((
        f"{fn}[recurrentgemma-9b x3 4x2 prefill "
        + "x".join(map(str, m["shape"])) + "]", src, replaces, m,
        mesh["prefill"]["launches"]["rglru"]))
    # The launch phase's pad_conv_relu(use_kernel=True) calls: one launch
    # a counted call.
    for name, m in launch["conv"].items():
        cnn_entries.append((f"fused_pad_conv_relu[pad_conv_relu {name}]",
                            *conv_src, m, m["launches"]))
    cnn_entries.append((
        "matmul[ops.mm " + "x".join(map(str, MM_SHAPE)) + "]",
        "src/repro_torch/csrc/matmul.cu",
        "src/repro/kernels/matmul/matmul.py:49", slice_measured["matmul"],
        mm_run["launches"]["matmul"]))
    for name, src, replaces, m, launches in cnn_entries:
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **f32_bound(m)})
    record["kernels"] = entries
    record["card"] = card
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total {record['seconds']:.1f} s")

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
