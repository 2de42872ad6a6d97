"""Compile ResNet-18 (Table III workload) end to end through the
``codo_torch.compile`` frontend of the PyTorch port: the Opt1..Opt5
ablation of Table VII, per-pass diagnostics, the compile cache (memory
tier + cold-restart disk reload, the reloaded design executed on the
device), and the resource/performance sweep of Fig. 11.

    PYTHONPATH=src python examples/torch/compile_resnet18.py
    PYTHONPATH=src python examples/torch/compile_resnet18.py --device cpu
    PYTHONPATH=src python examples/torch/compile_resnet18.py \\
        --cache-dir /tmp/codo_cache --artifact /tmp/resnet18.json

ResNet-18 is a traced function (``resnet18_fn`` in
``repro_torch/models/dataflow_models.py``), so the whole flow is:
function -> trace -> six passes -> executable design on the card (the
CPU with ``--device cpu``).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import codo_torch  # noqa: E402
from repro_torch.api import resolve_device  # noqa: E402
from repro_torch.core import ABLATION_PRESETS, CompileCache  # noqa: E402
from repro_torch.models.dataflow_models import (random_inputs,  # noqa: E402
                                                resnet18_fn)

SHAPE = (1, 3, 32, 32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-dir", default="",
                    help="disk compile-cache dir for the cold-restart demo")
    ap.add_argument("--artifact", default="",
                    help="export/import the opt5 design as a versioned JSON "
                         "artifact at this path (docs/artifact_format.md)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card; 'cpu')")
    args = ap.parse_args()
    device = resolve_device(args.device)

    def compile_resnet(**kwargs):
        return codo_torch.compile(resnet18_fn, SHAPE, name="resnet18_32",
                                  device=device, **kwargs)

    program = compile_resnet()
    g = program.source
    print(f"resnet18(3x32x32): traced {len(g.tasks)} tasks, "
          f"{len(g.buffers)} buffers from one Python function")

    print("\n== ablation (Table VII / Fig. 10, presets are data) ==")
    for name in ABLATION_PRESETS:
        c = compile_resnet(options=codo_torch.CodoOptions.preset(name))
        print(f"  {name} {'+'.join(ABLATION_PRESETS[name]):<42s}"
              f" speedup {c.speedup:9.1f}x  fifo {c.fifo_fraction:4.0%}"
              f"  compile {c.compile_seconds*1e3:6.1f} ms")

    print("\n== per-pass diagnostics (opt5) ==")
    c = compile_resnet(options=codo_torch.CodoOptions.opt5(), cache=None)
    print(c.diagnostics.table())

    print("\n== compile cache (memory tier) ==")
    cache = CompileCache()
    cold = compile_resnet(cache=cache)
    warm = compile_resnet(cache=cache)   # fresh trace, same structure
    print(f"  cold {cold.compile_seconds*1e3:8.1f} ms")
    print(f"  warm {warm.compile_seconds*1e3:8.1f} ms "
          f"(hit={warm.cache_hit}, same speedup={warm.speedup == cold.speedup})")

    if args.cache_dir:
        print(f"\n== cold-restart reload (disk tier at {args.cache_dir}) ==")
        compile_resnet(cache=CompileCache(disk_dir=args.cache_dir))
        fresh = CompileCache(disk_dir=args.cache_dir)
        reloaded = compile_resnet(cache=fresh)
        print(f"  reload: hit={reloaded.cache_hit} "
              f"disk_hits={fresh.stats.disk_hits} "
              f"compile {reloaded.compile_seconds*1e3:.1f} ms")
        assert all(t.fn is not None for t in reloaded.graph.tasks)
        out = reloaded.lower(jit=False)(reloaded.make_env(
            **random_inputs(reloaded.graph)))
        print(f"  reloaded design executed on {device}: outputs "
              f"{sorted(out)} ✓")

    if args.artifact:
        print(f"\n== portable artifact ({args.artifact}) ==")
        c.export(args.artifact)
        imported = codo_torch.load(args.artifact, device=device)
        out = imported.lower(jit=False)(imported.make_env(
            **random_inputs(imported.graph)))
        print(f"  imported design executed on {device}: outputs "
              f"{sorted(out)} ✓")
        print("  CLI equivalents:")
        print("    python -m repro_torch.core.compiler --configs resnet18 "
              "--opts opt5 --export artifacts/")
        print("    python -m repro_torch.core.compiler --import-artifact "
              f"{args.artifact}")
        print(f"    python -m repro_torch.serving.cli --artifact "
              f"{args.artifact}")

    print("\n== resource/performance trade-off (Fig. 11) ==")
    for budget in (128, 256, 512, 1024, 2048):
        c = compile_resnet(options=codo_torch.CodoOptions(budget_units=budget))
        print(f"  budget {budget:5d}: speedup {c.speedup:9.1f}x  "
              f"units {c.schedule_report.units_used:5d}")


if __name__ == "__main__":
    main()
