"""Quickstart on the PyTorch port: compile the paper's motivating example
(Fig. 2) with ``codo_torch`` and run it on the card.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
    PYTHONPATH=src python examples/torch/quickstart.py --cache-dir /tmp/c

The workload is a plain Python function: ``codo_torch.compile`` traces it
into the pad → conv → relu task graph (the same structural hash as the
JAX package's trace), shows the detected dataflow violations, runs the
``codo_opt`` pipeline, executes the lowered design on the device and
checks it against both the eager function and the unoptimized oracle.
``--cache-dir`` reloads the compile through a fresh disk cache and runs
it again; ``--artifact PATH`` exports the design, loads it with
``codo_torch.load`` and runs that.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import codo_torch  # noqa: E402
from repro_torch.api import CARD_VERIFY, resolve_device  # noqa: E402
from repro_torch.core import CompileCache, violation_report  # noqa: E402
from repro_torch.kernels import register_all  # noqa: E402


def motivating(x):
    """Fig. 2: one padded conv + relu — traced into pad -> conv -> relu
    tasks with an order-mismatch violation on the pad->conv edge."""
    return codo_torch.F.conv(x, 8, 3, relu=True)


SHAPE = (1, 3, 32, 32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-dir", default="",
                    help="disk compile-cache dir: demonstrates that a "
                         "reloaded (cold-restart) compile still executes")
    ap.add_argument("--artifact", default="",
                    help="also export/import the design as a versioned "
                         "JSON artifact at this path")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu')")
    args = ap.parse_args()
    device = resolve_device(args.device)
    band = CARD_VERIFY if device.type == "cuda" else dict(rtol=1e-5,
                                                           atol=1e-5)

    register_all()                     # route fusion groups to the kernels

    program = codo_torch.compile(motivating, SHAPE, name="motivating",
                                 device=device)
    g = program.source

    print("== traced dataflow graph ==")
    print(g.summary())
    print("   task specs:", {t.name: t.spec.kind for t in g.tasks})
    print(f"   structural hash {g.structural_hash()}")
    print("\n== violations before compilation ==")
    print(violation_report(g))

    print("\n== codo_torch.compile ==")
    print(program.report())

    low = program.lower(jit=False)
    print("\n== lowering ==")
    print(low.summary())
    for grp in low.groups:
        print(f"  group {grp.gid}: {grp.tasks} -> {grp.kernel}")

    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    y = program(xt, jit=False)
    y_eager = motivating(xt)           # the same function, run eagerly
    np.testing.assert_allclose(y.cpu().numpy(), y_eager.cpu().numpy(),
                               **band)
    program.verify(x, **band)
    print(f"\ncompiled(x) == motivating(x) == oracle ✓  (output "
          f"{tuple(y.shape)} on {device})")

    if args.artifact:
        print(f"\n== portable artifact (JSON at {args.artifact}) ==")
        program.export(args.artifact)
        imported = codo_torch.load(args.artifact, device=device)
        assert (imported.graph.structural_hash()
                == program.graph.structural_hash())
        np.testing.assert_allclose(imported(xt, jit=False).cpu().numpy(),
                                   y.cpu().numpy(), **band)
        print("  imported design lowered and executed ✓")
        print("  CLI equivalents:")
        print("    python -m repro_torch.core.compiler --import-artifact "
              f"{args.artifact}")
        print("    python -m repro_torch.serving.cli --artifact "
              f"{args.artifact}")

    if args.cache_dir:
        print(f"\n== cold-restart demo (disk cache at {args.cache_dir}) ==")
        codo_torch.compile(motivating, SHAPE, name="motivating",
                           device=device,
                           cache=CompileCache(disk_dir=args.cache_dir))
        fresh = CompileCache(disk_dir=args.cache_dir)  # nothing in memory
        reloaded = codo_torch.compile(motivating, SHAPE, name="motivating",
                                      device=device, cache=fresh)
        print(f"  reload: cache_hit={reloaded.cache_hit} "
              f"(disk hits: {fresh.stats.disk_hits})")
        assert all(t.fn is not None for t in reloaded.graph.tasks), \
            "disk entry came back stripped"
        np.testing.assert_allclose(reloaded(xt, jit=False).cpu().numpy(),
                                   y.cpu().numpy(), **band)
        print("  reloaded design lowered and executed ✓ "
              "(no recompile, no closures — specs re-derive the numerics)")


if __name__ == "__main__":
    main()
