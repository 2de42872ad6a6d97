"""Serve a reduced GPT-2 with slot-based batched decoding on the PyTorch
port.

    PYTHONPATH=src python examples/torch/serve_lm.py
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu

The reference's arguments, passed to ``python -m repro_torch.serving.cli``
(on the card unless ``--device`` says otherwise).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.serving.cli import main as serve_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="",
                    help="device to serve on (default: the card; 'cpu')")
    args = ap.parse_args()
    argv = ["--arch", "gpt2-medium", "--smoke", "--requests", "8",
            "--batch", "4", "--max-new", "12", "--cache-len", "64"]
    if args.device:
        argv += ["--device", args.device]
    raise SystemExit(serve_main(argv))
