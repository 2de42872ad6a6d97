"""Perf iteration driver: cost one (arch × shape × mesh) cell under a set
of optimization-switch combinations and print the roofline-term
comparison — the hypothesis → change → measure loop as a command.

The counterpart of ``repro/launch/perf.py``::

    PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma-7b \\
        --shape train_4k \\
        --variant base \\
        --variant dots:REPRO_REMAT_POLICY=dots

Each variant runs the dry-run for the cell
(:mod:`repro_torch.launch.dryrun`) in a fresh subprocess, its switches
set in that child's environment only (the port reads them at import
time), and the parent prints a table of :func:`roofline_row` of each
record.  The roofline is the H100's (SXM, dense), not a TPU's:
989 TFLOP/s bfloat16, 495 TF32 and 67 float32 outside the tensor cores,
HBM at 3.35 TB/s, NVLink at 450 GB/s each way, 80 GB of memory.  A cell's
peak is that of its parameters' type; the port keeps TF32 off, so a
float32 cell's is the float32 one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HBM_BYTES", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "RooflineRow",
           "main", "roofline_row", "run_variant"]

# H100 SXM dense peaks (FLOP/s) by the parameters' type.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way, one card
HBM_BYTES = 80e9                # bytes of device memory

SRC = Path(__file__).resolve().parents[2]


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops_per_dev: float = 0.0
    hlo_flops_per_dev: float = 0.0
    useful_ratio: float = 0.0       # MODEL_FLOPS / walked FLOPs
    roofline_fraction: float = 0.0  # useful compute time / step bound
    peak_gib: float = 0.0
    fits_hbm: bool = True
    note: str = ""

    @property
    def step_bound_s(self) -> float:
        """Lower bound on step time: overlapped terms -> max."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_row(rec: dict) -> RooflineRow:
    """The three roofline terms of a dry-run record on the H100."""
    row = RooflineRow(rec["arch"], rec["shape"], rec["mesh"], rec["status"])
    if rec["status"] != "ok":
        row.note = rec.get("skip_reason", rec.get("error", ""))[:80]
        return row
    peak = PEAK_FLOPS[rec.get("dtype", "float32")]
    chips = rec["chips"]
    row.hlo_flops_per_dev = rec["flops_per_device"]
    row.model_flops_per_dev = rec["model_flops"] / chips
    row.compute_s = rec["flops_per_device"] / peak
    row.memory_s = rec["bytes_per_device"] / HBM_BW
    row.collective_s = rec["collective"]["total"] / NVLINK_BW
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.useful_ratio = (row.model_flops_per_dev
                        / max(row.hlo_flops_per_dev, 1e-30))
    useful_s = row.model_flops_per_dev / peak
    row.roofline_fraction = useful_s / max(row.step_bound_s, 1e-30)
    row.peak_gib = rec["memory"]["peak_per_device"] / 2**30
    row.fits_hbm = rec["memory"]["peak_per_device"] <= HBM_BYTES
    return row


def run_variant(arch: str, shape: str, mesh: str, name: str,
                env_pairs: list[str], outdir: Path) -> dict:
    """The dry-run record of the cell under ``env_pairs`` (``KEY=VALUE``),
    from a child process whose environment alone carries them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), *filter(None, [env.get("PYTHONPATH")])])
    for pair in env_pairs:
        k, v = pair.split("=", 1)
        env[k] = v
    vdir = outdir / name
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(vdir), "--force"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-2000:] or proc.stdout[-2000:])
    rec = json.loads(next(vdir.glob("*.json")).read_text())
    rec["variant"] = name
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", action="append", default=[],
                    help="name[:ENV=V,ENV=V...]; 'base' = no switches")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    outdir = (Path(args.out) if args.out
              else Path(tempfile.mkdtemp(prefix="perf_")))
    variants = args.variant or ["base"]

    rows = []
    for v in variants:
        name, _, envs = v.partition(":")
        pairs = [p for p in envs.split(",") if p]
        rec = run_variant(args.arch, args.shape, args.mesh, name, pairs,
                          outdir)
        rows.append((name, roofline_row(rec)))
        r = rows[-1][1]
        print(f"{name:<12s} compute={r.compute_s:9.4f}s "
              f"memory={r.memory_s:9.4f}s "
              f"collective={r.collective_s:9.4f}s dominant={r.dominant:<10s} "
              f"useful={r.useful_ratio:5.2f} "
              f"roofline={r.roofline_fraction:8.5f} "
              f"peak={r.peak_gib:6.2f}GiB", flush=True)
    if len(rows) > 1:
        base, last = rows[0][1], rows[-1][1]
        if base.roofline_fraction > 0:
            print(f"\nroofline gain {rows[-1][0]} vs {rows[0][0]}: "
                  f"{last.roofline_fraction / base.roofline_fraction:.2f}x")
    print(f"records in {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
