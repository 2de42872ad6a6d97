"""Multi-pod dry-run: cost every (architecture × input shape × mesh) cell
of the production meshes without running it.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell over 512 forced host devices and reads XLA's analyses.  The
port has no compiler to ask, so it builds the production meshes over
``torch.device("meta")`` positions, places parameters, optimizer state,
batch and cache on them as meta tensors by ``param_specs``,
``batch_specs`` and ``cache_specs``, and runs one step of the cell's
sharded program — ``jit_train_step(..., jit=False)``, ``jit_prefill_step``
or ``jit_serve_step`` — under the cost walker
(:mod:`repro_torch.launch.hlo_analysis`).  Nothing is computed: meta
tensors carry shapes only, and a kernel called on them charges its work
and returns a meta result.  Nothing here sets an environment variable.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # 2x16x16

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys: ``status``; ``flops_per_device``,
``bytes_per_device``, ``transcendentals``, ``collective`` (per type and
``total``) from the walker; ``memory`` (``argument_bytes``: one
position's shards exactly; ``output_bytes``; ``alias_bytes``: the donated
part of both; ``temp_bytes``: the most bytes a compute block held alive
above its inputs; ``peak_per_device`` by the reference's formula);
``model_flops``, ``params``, ``active_params``, ``chips`` and
``mesh_shape``.  ``xla_flops_raw``, ``xla_bytes_raw``, ``hlo_bytes``,
``compile_s`` and ``memory.generated_code_bytes`` have no counterpart
and are null (``note`` says why); ``ops`` counts the aten ops charged.

Per device: a position's share.  Compute is split over ``model`` as the
reference's GSPMD lays it out (``replicated_model_compute: false``): a
position is charged its data block's work of its model position (a split
layer at ``1 / model``, what every position computes whole in full), the
sums over ``model`` as all-reduces over the ``model`` group and the
vocab gathers as all-gathers.  The executor's work outside the blocks
(the AdamW update of every shard) is charged evenly over the positions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

NOTE = ("the port compiles nothing: xla_flops_raw, xla_bytes_raw, hlo_bytes, "
        "compile_s and generated_code_bytes have no counterpart; costs come "
        "from walking one step's aten ops on meta tensors "
        "(repro_torch.launch.hlo_analysis)")

__all__ = ["RESULTS", "build_cell", "main", "meta_mesh", "model_flops_for",
           "production_meta_mesh", "run_cell", "walk_cell"]


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS (global): 6·N_active·tokens for train, 2·N_active·tokens
    for inference-style cells."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def meta_mesh(shape, axes):
    """A :class:`~repro_torch.launch.mesh.Mesh` of ``shape`` over ``axes``
    whose every position is ``torch.device("meta")``."""
    import torch

    from repro_torch.distributed.plan import MeshSpec
    from repro_torch.launch.mesh import Mesh
    spec = MeshSpec(tuple(zip(axes, shape)))
    return Mesh(spec, [torch.device("meta")] * spec.size)


def production_meta_mesh(*, multi_pod: bool = False):
    """The reference's production meshes — (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") — over meta
    positions."""
    if multi_pod:
        return meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return meta_mesh((16, 16), ("data", "model"))


def _shard_bytes(tree, position: int = 0) -> int:
    """The bytes ``position`` holds of every placed leaf of ``tree``."""
    from repro_torch.models.layers import tree_leaves
    return sum(a.shards[position].numel() * a.shards[position].element_size()
               for a in tree_leaves(tree))


def _split_bytes(tree, shardings) -> int:
    """The bytes one position holds of ``tree`` split by ``shardings``."""
    import math

    from repro_torch.models.layers import tree_leaves
    total = 0
    for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        total += math.prod(sh.shard_shape(t.shape)) * t.element_size()
    return total


def _nbytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def build_cell(arch_name: str, shape_name: str, mesh, *, cfg=None,
               shape=None, accum: int | None = None):
    """``(run, memory)`` for the cell on ``mesh``: ``run()`` runs one step
    of the cell's sharded program on meta state placed on the mesh, and
    ``memory(outputs)`` gives a position's argument, output and alias
    bytes after it.  ``cfg`` / ``shape`` replace the catalog's (a cut
    configuration); a train cell takes ``accum`` microbatches
    (``DRYRUN_ACCUM``, default 4, when None)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import (as_shardings, cache_specs,
                                                  place)
    from repro_torch.models import batch_spec
    from repro_torch.models import transformer as tf
    from repro_torch.serving.generator import (jit_prefill_step,
                                               jit_serve_step)
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.training.train_loop import (jit_train_step,
                                                 train_state_shardings)

    cfg = cfg or get_config(arch_name)
    shape = shape or SHAPES[shape_name]
    pshapes = tf.param_shapes(cfg)
    batch = batch_spec(cfg, shape)

    if shape.kind == "train":
        if accum is None:
            accum = int(os.environ.get("DRYRUN_ACCUM", "4"))
        step = jit_train_step(cfg, mesh, pshapes, batch, OptConfig(),
                              accum=accum, jit=False)
        sh = train_state_shardings(pshapes, mesh, cfg)
        params = place(pshapes, sh["params"])
        opt = place(adamw_init(pshapes), sh["opt"])

        def run():
            return step(params, opt, batch)

        def memory(outputs):
            state = _shard_bytes(params) + _shard_bytes(opt)
            metrics = _nbytes(outputs[2])
            return {"params": _shard_bytes(params), "opt": _shard_bytes(opt),
                    "batch": _shard_bytes(step.bufs)}, state + metrics, state
        return run, memory

    if shape.kind == "prefill":
        step = jit_prefill_step(cfg, mesh, pshapes, batch)
        params = place(pshapes, step.pshard)

        def run():
            return step(params, batch)

        def memory(outputs):
            return ({"params": _shard_bytes(params),
                     "batch": _split_bytes(batch, step.bshard)},
                    _nbytes(outputs), 0)
        return run, memory

    cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")
    step = jit_serve_step(cfg, mesh, pshapes, cache, jit=False)
    params = place(pshapes, step.pshard)
    cache = place(cache, as_shardings(cache_specs(cache, mesh, cfg), mesh))
    tokens = batch["tokens"]

    def run():
        return step(params, tokens, cache)

    def memory(outputs):
        tok = _split_bytes(tokens, step.tshard)
        held = _shard_bytes(cache)
        return ({"params": _shard_bytes(params), "tokens": tok,
                 "cache": held}, tok + _nbytes(outputs[1]) + held, held)
    return run, memory


def walk_cell(run, memory, mesh) -> dict:
    """Run ``run()`` under the cost walker at a position's share of the
    mesh's work; the record's cost and memory fields."""
    from repro_torch.launch.hlo_analysis import CostWalker
    t0 = time.time()
    with CostWalker() as walker, walker.share(1.0 / mesh.size):
        outputs = run()
    walk_s = time.time() - t0
    parts, output_bytes, alias_bytes = memory(outputs)
    cost = walker.cost
    coll = dict(cost.collective)
    coll["total"] = cost.collective_total
    argument_bytes = sum(parts.values())
    temp_bytes = walker.block_temp
    return dict(
        walk_s=round(walk_s, 2),
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        transcendentals=float(cost.transcendentals),
        ops=float(cost.ops),
        blocks=walker.blocks,
        # the whole step in full, as one device runs it holding every
        # position (a debug mesh)
        flops_one_device=float(walker.total.flops),
        bytes_one_device=float(walker.total.bytes),
        collective=coll,
        memory=dict(
            argument_bytes=argument_bytes,
            argument_parts=parts,
            output_bytes=output_bytes,
            temp_bytes=temp_bytes,
            alias_bytes=alias_bytes,
            generated_code_bytes=None,
            # per-device peak = args + temps (aliased buffers counted once)
            peak_per_device=(argument_bytes + temp_bytes + output_bytes
                             - alias_bytes),
            # every position's state on one device, as a debug mesh holds
            # it, plus the most the whole step held alive above it
            one_device_peak=(mesh.size * argument_bytes
                             + walker.peak_bytes)),
    )


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, *, mesh=None,
             cfg=None, shape=None, accum: int | None = None) -> dict:
    """The cell's record (see the module docstring).  ``mesh`` replaces
    the production mesh of ``mesh_kind``; ``cfg`` / ``shape`` the
    catalog's entries."""
    from repro_torch.configs import SHAPES, get_config
    cfg = cfg or get_config(arch_name)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "model_flops": model_flops_for(cfg, shape),
           "dtype": cfg.dtype}
    ok, why = cfg.runnable(shape)
    if not ok:
        rec.update(status="skipped", skip_reason=why)
        return rec
    if mesh is None:
        mesh = production_meta_mesh(multi_pod=(mesh_kind == "multi"))
    rec["mesh_shape"] = dict(mesh.shape)
    rec["chips"] = mesh.size
    try:
        t0 = time.time()
        run, memory = build_cell(arch_name, shape_name, mesh, cfg=cfg,
                                 shape=shape, accum=accum)
        lower_s = round(time.time() - t0, 2)
        rec.update(status="ok", lower_s=lower_s, compile_s=None,
                   **walk_cell(run, memory, mesh),
                   xla_flops_raw=None, xla_bytes_raw=None, hlo_bytes=None,
                   replicated_model_compute=False, note=NOTE)
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ASSIGNED, SHAPES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (the 10 assigned)")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have a JSON")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(ASSIGNED) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                name = f"{arch}__{shape}__{mesh_kind}.json"
                path = outdir / name
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    print(f"skip (cached) {name}: {rec['status']}")
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind)
                rec["wall_s"] = round(time.time() - t0, 2)
                path.write_text(json.dumps(rec, indent=1))
                mem = rec.get("memory", {}).get("peak_per_device", 0) / 2**30
                print(f"{rec['status']:<8s} {name:<58s} "
                      f"flops/dev={rec.get('flops_per_device', 0):.3e} "
                      f"coll={rec.get('collective', {}).get('total', 0):.3e}B "
                      f"peak={mem:.2f}GiB wall={rec['wall_s']}s",
                      flush=True)
                if rec["status"] == "error":
                    failures += 1
                    print(rec["error"], file=sys.stderr)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
