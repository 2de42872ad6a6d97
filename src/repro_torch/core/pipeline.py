"""Task-level pipeline executor — CODO's dataflow execution on a mesh of
stages.

The PyTorch port of ``repro/core/pipeline.py``.  The paper's accelerator
overlaps *tasks* on one FPGA; on a mesh the same schedule maps onto
pipeline parallelism: each stage owns a mesh position, activations stream
stage to stage (the FIFO), and microbatches fill the pipeline exactly like
Fig. 1(a)'s elements.

The reference runs it as ``shard_map`` over a ``stage`` axis with a
``jax.lax.scan`` over the ticks.  Here one process drives the stage
positions in lockstep (as the sharded lowering does), over
``num_microbatches + num_stages - 1`` ticks of the classic GPipe
fill/steady/drain schedule: at each tick stage 0 injects the next
microbatch, every stage holding a microbatch applies its function with
its own slice of the parameters on its own device, the last stage emits,
and the ring moves every activation one stage forward (a copy to the next
position's device).  A stage in the bubble does no work.

The stage functions must be shape-preserving (activation (mb, ...) in and
out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

__all__ = ["PipelineSchedule", "pipeline_fn", "reference_serial"]


@dataclass
class PipelineSchedule:
    num_stages: int
    num_microbatches: int

    @property
    def ticks(self) -> int:
        return self.num_microbatches + self.num_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.num_stages - 1) / self.ticks


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_fn(stage_fns: Sequence[Callable[[Any, Any], Any]], mesh,
                axis: str = "stage"):
    """Build a pipelined forward: ``(stacked_params, x) -> y``.

    ``stacked_params`` is a tree (dicts, lists, tuples) whose leaves have a
    leading ``stage`` dim (one slice per stage, placed on that stage's
    position).  ``x`` is (num_microbatches, mb, ...) with outputs of the
    same shape, on the mesh's first device.  ``mesh`` is a
    :class:`~repro_torch.launch.mesh.Mesh` with an ``axis`` of
    ``len(stage_fns)`` positions; each stage's position is the one at that
    coordinate of ``axis`` (and 0 on any other axis).
    """
    if mesh.distributed:
        raise NotImplementedError(
            f"pipeline_fn on {mesh!r}: the pipeline across ranks is not "
            f"ported yet (ROADMAP.md, Queue 1 item 10 (Multi-card meshes))")
    num_stages = mesh.shape[axis]
    if len(stage_fns) != num_stages:
        raise ValueError(f"{len(stage_fns)} stage functions for a {axis!r} "
                         f"axis of {num_stages} positions")
    group = next(g for g in mesh.groups(axis)
                 if all(mesh.coords(p)[a] == 0 for p in g
                        for a in mesh.axis_names if a != axis))
    devices = [mesh.devices[p] for p in group]

    def run(stacked_params, x):
        import torch
        params = [_tree_map(lambda a, s=s: a[s].to(devices[s]),
                            stacked_params) for s in range(num_stages)]
        nmb = x.shape[0]
        home = devices[0]
        outs = torch.empty(x.shape, dtype=x.dtype, device=home)
        held: list = [None] * num_stages    # activation each stage holds
        for t in range(nmb + num_stages - 1):
            if t < nmb:                     # stage 0 injects microbatch t
                held[0] = x[t].to(devices[0])
            ys: list = [None] * num_stages
            for s in range(num_stages):
                if held[s] is not None:
                    ys[s] = stage_fns[s](params[s], held[s])
            if ys[-1] is not None:          # the last stage emits
                outs[t - (num_stages - 1)].copy_(ys[-1])
            # stream forward one stage (the inter-stage FIFO)
            held = [None] + [None if y is None else y.to(devices[s + 1])
                             for s, y in enumerate(ys[:-1])]
        return outs

    return run


def reference_serial(stage_fns, params_stacked, x):
    """Oracle: run stages sequentially over all microbatches (no
    pipeline)."""
    import torch
    nmb = x.shape[0]
    outs = []
    for m in range(nmb):
        h = x[m]
        for s, f in enumerate(stage_fns):
            p = _tree_map(lambda a, s=s: a[s], params_stacked)
            h = f(p, h)
        outs.append(h)
    return torch.stack(outs)
