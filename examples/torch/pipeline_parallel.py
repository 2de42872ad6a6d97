"""Pipeline-parallel execution on the PyTorch port: CODO's balanced stages
on a mesh of positions (Fig. 1 at pod scale).

    PYTHONPATH=src python examples/torch/pipeline_parallel.py
    PYTHONPATH=src python examples/torch/pipeline_parallel.py --device cpu

The CODO scheduler assigns tasks to latency-balanced stages
(``core.schedule.assign_stages``); the pipeline executor streams
microbatches through the stage positions, one process driving them in
lockstep — the inter-stage FIFO.  The four stage positions come from
``make_debug_mesh`` and all sit on one device: the card, or the CPU.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import assign_stages, codo_opt  # noqa: E402
from repro_torch.core.pipeline import (PipelineSchedule,  # noqa: E402
                                       pipeline_fn, reference_serial)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.dataflow_models import autoencoder  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of the stage positions (default: the "
                         "card; 'cpu')")
    args = ap.parse_args()

    # 1) CODO stage balancing on a real task graph
    g = autoencoder(64, 784)
    compiled = codo_opt(g)
    stages = assign_stages(compiled.graph, compiled.options.hw, num_stages=4)
    print("CODO-balanced stages:")
    for i, names in enumerate(stages):
        print(f"  stage {i}: {names}")

    # 2) pipeline execution of a 4-stage MLP over 8 microbatches
    mesh = make_debug_mesh((4,), ("stage",), device=args.device)
    device = mesh.devices[0]
    D, nmb, mb = 32, 8, 4

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
                  (rng.standard_normal((4, D, D)) * 0.5).astype(np.float32)
              ).to(device),
              "b": torch.zeros((4, D), device=device)}
    x = torch.from_numpy(rng.standard_normal((nmb, mb, D)).astype(
        np.float32)).to(device)

    fn = pipeline_fn([stage] * 4, mesh)
    y = fn(params, x)
    y_ref = reference_serial([stage] * 4, params, x)
    err = float((y - y_ref).abs().max())
    sched = PipelineSchedule(num_stages=4, num_microbatches=nmb)
    print(f"\npipeline vs serial max err: {err:.2e}")
    print(f"ticks={sched.ticks} bubble={sched.bubble_fraction:.1%} "
          f"(GPipe fill/drain) on {mesh!r}")
    assert err < 1e-5


if __name__ == "__main__":
    main()
