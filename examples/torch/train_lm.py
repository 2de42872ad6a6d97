"""End-to-end training driver on the PyTorch port: train a reduced GPT-2
for a few hundred steps with checkpointing, failure injection, and
restart.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200
    PYTHONPATH=src python examples/torch/train_lm.py --steps 60 --fail-at 30
    PYTHONPATH=src python examples/torch/train_lm.py --steps 30 --device cpu

On the failure run, re-invoke with --resume to continue from the last
checkpoint (bit-exact with the uninterrupted run: deterministic data).
The reference's arguments, passed to ``python -m
repro_torch.training.cli`` (on the card unless ``--device`` says
otherwise); checkpoints go to ``build/train_lm_ckpt`` beside the
repository's sources unless ``--ckpt`` names another directory.
"""

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.training.cli import main as train_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card; 'cpu')")
    args = ap.parse_args()
    argv = ["--arch", "gpt2-medium", "--smoke", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--ckpt", args.ckpt,
            "--ckpt-every", "20"]
    if args.fail_at:
        argv += ["--fail-at", str(args.fail_at)]
    if args.resume:
        argv += ["--resume"]
    if args.device:
        argv += ["--device", args.device]
    raise SystemExit(train_main(argv))
