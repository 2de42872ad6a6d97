"""Training launcher of the PyTorch port (the counterpart of
``repro/training/cli.py``), on the card unless ``--device`` says
otherwise.

CPU-scale (smoke config):
    PYTHONPATH=src python -m repro_torch.training.cli --arch gemma-7b \\
        --smoke --steps 20 --batch 4 --seq 128 --device cpu

On one H100 (the published widths and dtype, bfloat16 parameters and
float32 moments):
    PYTHONPATH=src python -m repro_torch.training.cli --arch mamba2-780m \\
        --steps 6 --batch 2 --seq 2048 --ckpt /tmp/ckpt

The launcher wires: config → data pipeline (prefetching numpy batches) →
the train step (remat, captured into a CUDA graph on the card, parameters
and optimizer state written in place) → async checkpointer →
heartbeat/straggler monitors.  ``--fail-at N`` injects a failure after
step N and exits with 42; ``--resume`` continues from the newest
checkpoint.

``--compiled`` instead drives :func:`~repro_torch.training.train_loop.
train_compiled` over a graph-level-autodiff
:class:`~repro_torch.api.CompiledTrainStep` (the GPT-2 block regression
loss): forward, backward and AdamW update each compiled through the full
pass pipeline, the backward's chains routed to ``fused_matmul_grad``
where the gate takes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import SHAPES, get_config  # noqa: F401 — re-export
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (SimulatedFailure, resume,
                                             resume_compiled, train,
                                             train_compiled)


def _main_compiled(args) -> int:
    """The ``--compiled`` path: graph-level autodiff end to end."""
    import numpy as np

    import repro_torch.api as codo
    from repro_torch.models.dataflow_models import gpt2_block_loss_fn

    d_model = args.d_model or 256
    oc = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                   total_steps=args.steps)
    step = codo.compile(gpt2_block_loss_fn, (args.seq, d_model),
                        (args.seq, d_model), grad=True,
                        name="gpt2_block_loss", opt=oc, device=args.device)
    rng = np.random.default_rng(args.seed)

    def batch_fn(i: int) -> tuple:
        x = rng.standard_normal((args.seq, d_model)).astype(np.float32)
        return x, 0.9 * x  # learnable regression target

    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    t0 = time.time()
    try:
        if args.resume and ckpt is not None and ckpt.steps():
            params, opt, report = resume_compiled(
                step, ckpt, steps=args.steps, batch_fn=batch_fn,
                checkpoint_every=args.ckpt_every)
        else:
            params, opt, report = train_compiled(
                step, steps=args.steps, batch_fn=batch_fn, checkpointer=ckpt,
                checkpoint_every=args.ckpt_every,
                fail_at=args.fail_at or None)
    except SimulatedFailure as e:
        print(f"!! {e} — restart with --resume to continue from the last "
              f"checkpoint")
        return 42
    finally:
        if ckpt is not None:
            ckpt.wait()
    dt = time.time() - t0
    print(f"compiled train step: steps={report.steps_done} "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"({dt:.1f}s, {report.straggler_flags} straggler flags, "
          f"checkpoints at {report.checkpoints}) on {step.device}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help="ArchConfig name (required unless --compiled)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--compiled", action="store_true",
                    help="drive a pipeline-compiled train step "
                         "(graph-level autodiff) instead of the "
                         "transformer loop")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a failure after N steps (restart demo)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0, help="override d_model")
    ap.add_argument("--vocab", type=int, default=0, help="override vocab")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)

    if args.compiled:
        return _main_compiled(args)
    if not args.arch:
        ap.error("--arch is required (or pass --compiled)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
        over["d_ff"] = 4 * args.d_model
        over["head_dim"] = 0
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    oc = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                   total_steps=args.steps)

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    source = SyntheticLM(cfg, dc)
    prefetch = Prefetcher(source)
    batches: dict[int, dict] = {}

    def batch_fn(step: int) -> dict:
        while step not in batches:
            s, b = prefetch.next()
            batches[s] = b
        return batches.pop(step)        # numpy: the step copies it over

    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    t0 = time.time()
    try:
        if args.resume and ckpt is not None and ckpt.steps():
            params, opt, report = resume(
                cfg, ckpt, steps=args.steps, batch_fn=batch_fn, oc=oc,
                seed=args.seed, checkpoint_every=args.ckpt_every,
                device=args.device)
        else:
            params, opt, report = train(
                cfg, steps=args.steps, batch_fn=batch_fn, checkpointer=ckpt,
                checkpoint_every=args.ckpt_every, oc=oc, seed=args.seed,
                fail_at=args.fail_at or None, device=args.device)
    except SimulatedFailure as e:
        print(f"!! {e} — restart with --resume to continue from the last "
              f"checkpoint")
        prefetch.close()
        return 42
    finally:
        if ckpt is not None:
            ckpt.wait()

    prefetch.close()
    dt = time.time() - t0
    print(f"arch={cfg.name} steps={report.steps_done} "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f} "
          f"({dt:.1f}s, {report.straggler_flags} straggler flags, "
          f"checkpoints at {report.checkpoints}) on "
          f"{opt['step'].device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
