"""Lowering: a :class:`CompiledDataflow` → an executable step runner on
torch tensors.

The PyTorch counterpart of ``repro/core/lowering.py``.  FIFO edges become
*fusion groups* exactly as in the reference; which implementation runs a
group is the same *routing* decision (:mod:`repro_torch.core.routing`):
producer→consumer chains matching a registered
:class:`~repro_torch.core.routing.KernelPattern` execute as one
hand-written kernel step (a CUDA kernel for tensors on the card, its plain
PyTorch version for tensors on the CPU); everything else runs task by task
through the op registry.  Group strings keep the reference's
``pallas:<pattern>`` / ``xla-fused`` names so routing tables compare like
for like.  ``CODO_DISABLE_PALLAS=1`` turns all routing off.

``jit=True`` (the default, as in the reference) wraps the step list where
the reference wraps it in ``jax.jit``: in a
:class:`~repro_torch.core.capture.CapturedProgram`, which captures it into
a CUDA graph per input signature on the card and runs it as it is on the
CPU.  ``jit=False`` runs the step list eagerly everywhere.

``sharding=`` (a :class:`~repro_torch.distributed.plan.ShardingPlan`)
lowers the multi-device program.  The reference wraps the step list in
``shard_map`` under ``jax.jit``: one process drives every position of the
mesh.  The port does the same as a lockstep interpreter over the mesh's
positions (:class:`~repro_torch.launch.mesh.Mesh`, a device for each):
each input and weight is split by its
:class:`~repro_torch.distributed.plan.ShardSpec` onto its position's
device, every step runs on every position at its local shapes (a routed
chain launches its kernel once a position), the plan's collectives run
before and after their anchor tasks across each group of positions along
their axis (:mod:`repro_torch.distributed.collectives`), and the outputs
are reassembled by their specs on the mesh's first device.  With ``jit``
the whole lockstep run is captured as one CUDA graph per input signature
when every position sits on one card; a mesh over several cards raises
:class:`~repro_torch.core.capture.CaptureError` there (collectives
between cards are not ported yet).

Lowering results are memoized like compiles: keyed on the compiled graph's
``structural_hash()`` (which covers the fusion decisions), the lowering
flags, the routing switches of
:func:`~repro_torch.core.routing.routing_state_key` for the program's
backend, the op-registry epoch and, for a sharded program, the plan's
digest and the mesh's devices.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .capture import CaptureError, CapturedProgram, clear_graphs, run_steps
from .compiler import CompiledDataflow
from .costmodel import routing_backend
from .graph import DataflowGraph, GraphError
from .ops import registry_epoch as _ops_epoch
from .routing import (XLA_FUSED, KernelPattern, RoutedKernel,
                      ensure_kernel_patterns, fifo_groups,
                      register_kernel_pattern, registered_patterns,
                      route_groups, routing_state_key)


def register_group_kernel(pattern: tuple[str, ...],
                          factory: Callable[..., Callable]) -> None:
    """Legacy exact-op registration (pre-routing API): ``pattern`` is the
    full op tuple of a group and ``factory(graph, group)`` builds the
    step.  Kept as a shim over :func:`repro_torch.core.routing.
    register_kernel_pattern`; new kernels should register a
    :class:`~repro_torch.core.routing.KernelPattern` directly."""
    def adapter(graph, group, tasks):
        # Old factories index group.tasks positionally, assuming the match
        # covers the whole group; hand them a group view of just the chain.
        chain = FusionGroup(group.gid, [t.name for t in tasks],
                            tuple(t.op for t in tasks))
        return factory(graph, chain)

    register_kernel_pattern(KernelPattern(
        name="+".join(pattern), pattern=tuple(pattern), factory=adapter,
        description="legacy exact-op registration"))


@dataclass
class FusionGroup:
    gid: int
    tasks: list[str]
    ops: tuple[str, ...]
    kernel: str = XLA_FUSED       # or "pallas:<pattern>[+<pattern>...]"
    routes: list[RoutedKernel] = field(default_factory=list)
    # Cost-gate record: structural matches the gate turned down, the
    # group-level decision, and predicted cycles both ways.
    rejected: list[RoutedKernel] = field(default_factory=list)
    decision: str = "generic"     # "routed" | "generic" | "disabled"
    predicted_routed_cycles: float = 0.0
    predicted_generic_cycles: float = 0.0


@dataclass
class LoweredProgram:
    graph: DataflowGraph
    groups: list[FusionGroup]
    fn: Callable[[dict], dict]          # env(inputs+weights) -> outputs
    materialized: list[str] = field(default_factory=list)   # HBM intermediates

    def __call__(self, env: dict[str, Any]) -> dict[str, Any]:
        return self.fn(env)

    @property
    def routed_groups(self) -> list[FusionGroup]:
        return [g for g in self.groups if g.routes]

    def summary(self) -> str:
        return (f"lowered {self.graph.name}: {len(self.groups)} fusion groups "
                f"({sum(len(g.tasks) for g in self.groups)} tasks, "
                f"{len(self.routed_groups)} kernel-routed), "
                f"{len(self.materialized)} HBM intermediates")


def fusion_groups(graph: DataflowGraph, impl: dict[str, str]) -> list[FusionGroup]:
    """The :func:`~repro_torch.core.routing.fifo_groups` partition as
    :class:`FusionGroup` records, with each task's ``fused_group`` id set.
    Routing is a separate decision — see :func:`~repro_torch.core.routing.
    route_groups`."""
    groups = []
    for gid, names in enumerate(fifo_groups(graph, impl)):
        groups.append(FusionGroup(gid, names,
                                  tuple(graph.task(n).op for n in names)))
        for n in names:
            graph.task(n).fused_group = gid
    return groups


# Memoized lowerings: structural key -> LoweredProgram (LRU).
_LOWER_CACHE: OrderedDict[tuple, LoweredProgram] = OrderedDict()
_LOWER_LOCK = threading.Lock()
LOWER_CACHE_STATS = {"hits": 0, "misses": 0}


def _lower_cache_size() -> int:
    return max(1, int(os.environ.get("CODO_LOWER_CACHE_SIZE", "64")))


def clear_lower_cache() -> None:
    """Drop every memoized lowering and release every captured graph."""
    with _LOWER_LOCK:
        _LOWER_CACHE.clear()
        LOWER_CACHE_STATS.update(hits=0, misses=0)
    clear_graphs()


def _build_steps(graph: DataflowGraph, groups: list[FusionGroup],
                 use_registered_kernels: bool) -> list[tuple[str, Callable]]:
    """The executable step list: routed chains become one kernel step
    emitted at the chain's *last* task position (every external operand of
    every matched task is in scope by then); everything else runs task by
    task."""
    step_at: dict[str, Callable[[dict], dict]] = {}
    skip: set[str] = set()
    if use_registered_kernels:
        pats = {p.name: p for p in registered_patterns()}
        for g in groups:
            built: list[RoutedKernel] = []
            for route in g.routes:
                pat = pats.get(route.kernel)
                tasks = [graph.task(n) for n in route.tasks]
                if pat is None:
                    step = None
                elif route.tile is not None:    # tuned blocking wins
                    step = pat.factory(graph, g, tasks, tile=route.tile)
                else:
                    step = pat.factory(graph, g, tasks)
                if step is None:        # factory declined at build time
                    continue
                built.append(route)
                step_at[route.tasks[-1]] = step
                skip.update(route.tasks[:-1])
            if len(built) != len(g.routes):
                for r in g.routes:
                    if r not in built:
                        r.decision = "declined"     # factory said no
                        g.rejected.append(r)
                g.routes = built
                g.kernel = ("pallas:" + "+".join(r.kernel for r in built)
                            if built else XLA_FUSED)
                g.decision = "routed" if built else "generic"
    else:
        for g in groups:
            g.routes, g.rejected = [], []
            g.kernel = XLA_FUSED
            g.decision = "generic"

    steps: list[tuple[str, Callable[[dict], dict]]] = []
    for t in graph.toposort():
        if t.name in skip:
            continue
        steps.append((t.name, step_at.get(t.name, t.fn)))
    return steps


def _drop_sharded_routes(groups: list[FusionGroup], sharding) -> None:
    """Un-route any chain a collective lands inside.  A routed kernel step
    runs at the chain's *last* task with the interiors skipped, so the
    only anchor the sharded executor can honor is "after the last task"
    (the psum on a row-parallel matmul's output).  A gather before any
    chain task, or a reduction after an interior, would silently never
    run — fall back to the generic per-task path for that chain."""
    from repro_torch.distributed import collectives as _coll
    before, after = _coll.attach(sharding.steps)
    for g in groups:
        kept = []
        for r in g.routes:
            bad = any(t in before for t in r.tasks) or \
                any(t in after for t in r.tasks[:-1])
            if bad:
                r.decision = "sharded"      # collective inside the chain
                g.rejected.append(r)
            else:
                kept.append(r)
        if len(kept) != len(g.routes):
            g.routes = kept
            g.kernel = ("pallas:" + "+".join(r.kernel for r in kept)
                        if kept else XLA_FUSED)
            g.decision = "routed" if kept else "generic"


def place_sharding(sharding, mesh=None, device=None):
    """The :class:`~repro_torch.launch.mesh.Mesh` a sharded program runs
    on: ``mesh`` when given (its shape must be the plan's); else every
    position on the CPU for a CPU ``device``, and otherwise the first
    cards, one a position (``mesh_from_spec``, which raises on a host with
    fewer cards — there is no fallback to the CPU).  Inside a process
    group the mesh is the group's :func:`~repro_torch.launch.mesh.
    rank_mesh` (a ``mesh`` given may be one), each rank running its own
    positions."""
    import torch

    from repro_torch.launch.mesh import Mesh, mesh_from_spec
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= takes a repro_torch.launch.mesh.Mesh, "
                            f"got {type(mesh).__name__}")
        if mesh.spec != sharding.mesh:
            raise ValueError(f"the plan is for mesh {sharding.mesh.axes}, "
                             f"got a mesh of {mesh.spec.axes}")
        return mesh
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from repro_torch.launch.mesh import rank_mesh
        return rank_mesh(sharding.mesh, device=device)
    if device is not None and torch.device(device).type == "cpu":
        return Mesh(sharding.mesh, ["cpu"] * sharding.mesh.size)
    return mesh_from_spec(sharding.mesh)


# The scope entry of a sharded run that holds one buffer dict per mesh
# position (a key no buffer name can take).
_POSITIONS = object()


def _shard(value, spec, mesh, coords: dict, device):
    """The local block of ``value`` that the position at ``coords`` holds
    under ``spec``, dense, on ``device``."""
    for d, axis in enumerate(spec.dims):
        if axis is not None:
            size = value.shape[d] // mesh.shape[axis]
            value = value.narrow(d, coords[axis] * size, size)
    return value.contiguous().to(device)


def _assemble(name: str, spec, mesh, coords: list, scopes: list, device):
    """The global value of an output from its positions' local blocks (the
    positions at coordinate 0 of every axis the spec does not use).  On a
    mesh split over ranks ``scopes`` holds this rank's positions' (None
    for the others), the blocks come through one exchange, and every rank
    gets the whole output, as the reference's global array."""
    import torch

    from repro_torch.distributed.collectives import exchange
    used = {axis for axis in spec.dims if axis is not None}
    sources = [p for p, c in enumerate(coords)
               if not any(c[a] for a in c if a not in used)]
    local = next(sc for sc in scopes if sc is not None)[name]
    values = exchange(mesh, {p: scopes[p][name] for p in sources
                             if scopes[p] is not None}, sources,
                      ranks=range(mesh.world), like=local)
    if spec.is_replicated:
        return values[0].to(device)
    shape = [n * (1 if axis is None else mesh.shape[axis])
             for n, axis in zip(local.shape, spec.dims)]
    out = torch.empty(shape, dtype=local.dtype, device=device)
    for p, value in zip(sources, values):
        block = out
        for d, axis in enumerate(spec.dims):
            if axis is not None:
                n = local.shape[d]
                block = block.narrow(d, coords[p][axis] * n, n)
        block.copy_(value)
    return out


def _sharded_steps(graph: DataflowGraph, steps, outputs: list[str],
                   sharding, mesh) -> list[tuple[str, Callable]]:
    """The step list as a lockstep run over ``mesh``'s positions.

    A first step splits the env onto the positions (each entry the *local
    shard* its :class:`ShardSpec` dictates); each task's step then applies
    the plan's collectives anchored "before" it across every group of
    positions along their axis, runs on every position, and applies those
    anchored "after" it (psum, reduce_scatter + all_gather, the ring); a
    last step reassembles the outputs by their specs on the mesh's first
    device.  The reference's ``_sharded_program`` over ``shard_map``.

    On a mesh split over ranks each rank splits the env (whole on every
    rank) onto its own positions, runs their steps, applies each
    collective across ranks (:func:`~repro_torch.distributed.collectives.
    make_collective` given the group) and assembles the whole outputs on
    its own card."""
    from repro_torch.distributed import collectives as _coll

    before, after = _coll.attach(sharding.steps)
    emitted = {name for name, _f in steps}
    missing = [s.task for s in sharding.steps if s.task not in emitted]
    if missing:        # _drop_sharded_routes guarantees this never fires
        raise GraphError(
            f"collective anchored on skipped task(s) {missing}")
    fns = {id(s): _coll.make_collective(s, mesh) for s in sharding.steps}
    groups = {axis: mesh.groups(axis) for axis in mesh.axis_names}
    in_specs, out_specs = _coll.env_partition_specs(graph, sharding)
    coords = [mesh.coords(p) for p in range(mesh.size)]
    mine = set(mesh.local_positions)
    home = mesh.devices[min(mine)]

    def split(scope: dict) -> dict:
        extra = set(scope) - set(in_specs)
        if extra:
            raise GraphError(f"sharded program got unexpected env keys "
                             f"{sorted(extra)}")
        absent = set(in_specs) - set(scope)
        if absent:
            raise GraphError(f"sharded program is missing env keys "
                             f"{sorted(absent)}")
        scopes = [{} if p in mine else None for p in range(mesh.size)]
        for name, spec in in_specs.items():
            blocks: dict = {}           # positions holding the same block
            for c, device, local in zip(coords, mesh.devices, scopes):
                if local is None:       # another rank's position
                    continue
                key = (device,
                       tuple(None if a is None else c[a] for a in spec.dims))
                if key not in blocks:
                    blocks[key] = _shard(scope[name], spec, mesh, c, device)
                local[name] = blocks[key]
        return {_POSITIONS: scopes}

    def collective(s, scopes: list) -> None:
        fn = fns[id(s)]
        for group in groups[s.axis]:
            here = [p for p in group if p in mine]
            if not here:                # another rank's group
                continue
            got = fn([scopes[p][s.buffer] for p in here], group)
            for p, value in zip(here, got):
                scopes[p][s.buffer] = value

    def lockstep(name: str, f: Callable) -> Callable:
        pre, post = before.get(name, ()), after.get(name, ())

        def run(scope: dict) -> dict:
            scopes = scope[_POSITIONS]
            for s in pre:
                collective(s, scopes)
            for local in scopes:
                if local is not None:
                    local.update(f(local))
            for s in post:
                collective(s, scopes)
            return {}

        return run

    def assemble(scope: dict) -> dict:
        scopes = scope.pop(_POSITIONS)
        return {k: _assemble(k, out_specs[k], mesh, coords, scopes, home)
                for k in outputs}

    return ([("shard inputs", split)]
            + [(name, lockstep(name, f)) for name, f in steps]
            + [("assemble outputs", assemble)])


def lower(compiled: CompiledDataflow, jit: bool = True,
          use_registered_kernels: bool = True, *, memo: bool = True,
          device=None, sharding=None, mesh=None) -> LoweredProgram:
    """Lower ``compiled`` for a program on ``device`` (a ``torch.device``
    or its string; it selects the backend the routing gate prices, see
    :func:`~repro_torch.core.costmodel.routing_backend`).  The returned
    program runs on whatever device its env tensors lie on: captured into
    a CUDA graph on the card when ``jit`` (see
    :mod:`repro_torch.core.capture`), eagerly otherwise.

    ``sharding`` lowers the plan's multi-device program on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`; placed by
    :func:`place_sharding` when not given): see the module docstring."""
    # The compiler — not the user — wires the kernels in.
    ensure_kernel_patterns()
    graph = compiled.graph
    stripped = [t.name for t in graph.tasks if t.fn is None]
    if stripped:
        raise GraphError(
            f"cannot lower {graph.name}: {len(stripped)} tasks have no numeric "
            f"semantics (e.g. {stripped[0]!r}). These tasks were built from "
            "raw closures (not picklable), so their disk compile-cache entry "
            "is structural-only; build graphs with declarative OpSpecs "
            "(repro_torch.core.ops) for executable cache entries, or recompile "
            "with an in-memory cache / cache=None before lowering.")
    placed = ()
    if sharding is not None:
        mesh = place_sharding(sharding, mesh, device)
        local = mesh.local_devices
        if device is None:
            device = local[0]
        if jit and len(local) > 1:
            raise CaptureError(
                f"jit=True on {mesh!r}: capturing a sharded program whose "
                f"positions sit on several devices of one process is not "
                f"ported (ROADMAP.md, Queue 1 item 10 (Multi-card meshes)); "
                f"run one process a card (repro_torch/launch/ranks.py: "
                f"spawn, then launch.mesh.rank_mesh), lower it with "
                f"jit=False, or place every position on one card")
        placed = (sharding.digest(), tuple(str(d) for d in mesh.devices),
                  mesh.ranks, mesh.rank)
    backend = routing_backend(device)
    key = (graph.structural_hash(), bool(jit), bool(use_registered_kernels),
           *routing_state_key(backend), _ops_epoch(), placed)
    if memo:
        with _LOWER_LOCK:
            hit = _LOWER_CACHE.get(key)
            if hit is not None:
                _LOWER_CACHE.move_to_end(key)
                LOWER_CACHE_STATS["hits"] += 1
        if hit is not None:
            # Mirror the cached fusion decisions onto the caller's graph so
            # post-lowering introspection (fused_group ids) behaves as if
            # the lowering had run, then share the built program.
            for g in hit.groups:
                for n in g.tasks:
                    graph.task(n).fused_group = g.gid
            _record_routing(compiled, hit.groups)
            return LoweredProgram(graph, hit.groups, hit.fn,
                                  list(hit.materialized))
    impl = compiled.buffer_plan.impl if compiled.buffer_plan else {}
    groups = fusion_groups(graph, impl)
    if use_registered_kernels:
        route_groups(graph, groups, impl, hw=compiled.options.hw,
                     backend=backend)
    if sharding is not None:
        _drop_sharded_routes(groups, sharding)
    steps = _build_steps(graph, groups, use_registered_kernels)

    outputs = [b.name for b in graph.outputs()]
    # Interior buffers of routed chains never leave the kernel — even the
    # ping-pong-planned ones the generic path would bounce through HBM.
    swallowed = {graph.task(n).writes[0].buffer
                 for g in groups for r in g.routes for n in r.tasks[:-1]}
    materialized = [b.name for b in graph.intermediates()
                    if impl.get(b.name) == "pingpong"
                    and b.name not in swallowed]

    if sharding is not None:
        steps = _sharded_steps(graph, steps, outputs, sharding, mesh)
    if jit:
        program = CapturedProgram(steps, outputs)
    else:
        def program(env: dict) -> dict:
            return run_steps(steps, outputs, env)

    out = LoweredProgram(graph, groups, program, materialized)
    _record_routing(compiled, groups)
    if memo:
        with _LOWER_LOCK:
            LOWER_CACHE_STATS["misses"] += 1
            _LOWER_CACHE[key] = out
            _LOWER_CACHE.move_to_end(key)
            while len(_LOWER_CACHE) > _lower_cache_size():
                _LOWER_CACHE.popitem(last=False)
    return out


def _record_routing(compiled: CompiledDataflow,
                    groups: list[FusionGroup]) -> None:
    """Surface the routing decision on the design's diagnostics so it
    travels with reports.  Every entry records the cost gate's verdict and
    the predicted cycles both ways, not just the winning kernel name."""
    if compiled.diagnostics is not None:
        compiled.diagnostics.group_kernels = {
            str(g.gid): {
                "kernel": g.kernel,
                "decision": g.decision,
                "predicted_routed_cycles": round(
                    g.predicted_routed_cycles, 1),
                "predicted_generic_cycles": round(
                    g.predicted_generic_cycles, 1),
                "routes": [r.to_dict() for r in g.routes],
                "rejected": [r.to_dict() for r in g.rejected],
            } for g in groups}


def assert_outputs_close(got: dict, want: dict, *, rtol: float, atol: float,
                         what: str) -> None:
    """``np.testing.assert_allclose`` on every output in ``want`` (tensors
    are compared on the host in their own dtype, widened to float32 for
    bf16)."""
    for k in want:
        np.testing.assert_allclose(_host(got[k]), _host(want[k]),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"output {k} {what}")


def _host(x) -> np.ndarray:
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def lower_artifact(source, *, jit: bool = True,
                   use_registered_kernels: bool = True, memo: bool = True,
                   check_integrity: bool = True, device=None) -> LoweredProgram:
    """One-step path from an exported JSON artifact (a file path or parsed
    document, written by either package) to an executable program:
    ``import_artifact`` + :func:`lower` for ``device``.  Op kinds resolve
    against this package's registry."""
    from .artifact import import_artifact
    return lower(import_artifact(source, check_integrity=check_integrity,
                                 backend=routing_backend(device)),
                 jit=jit, use_registered_kernels=use_registered_kernels,
                 memo=memo, device=device)


def oracle_outputs(source_graph: DataflowGraph, env: dict) -> dict:
    """Run the *un-optimized* program — the golden reference the paper's
    auto-generated testbench compares against (§VII-C)."""
    return source_graph.execute(env)


def verify_lowering(source_graph: DataflowGraph, compiled: CompiledDataflow,
                    env: dict, rtol: float = 1e-5, atol: float = 1e-5,
                    sharding=None, *, device=None, mesh=None) -> None:
    """Lowered outputs must match the un-optimized oracle.  With a
    ``sharding`` plan the multi-device lowering is checked instead (on
    ``mesh``; see :func:`lower`)."""
    got = lower(compiled, jit=False, device=device, sharding=sharding,
                mesh=mesh)(env)
    assert_outputs_close(got, oracle_outputs(source_graph, env), rtol=rtol,
                         atol=atol, what="diverged after lowering")


def verify_sharding(compiled: CompiledDataflow, sharding, env: dict,
                    rtol: float = 1e-4, atol: float = 5e-5, *, device=None,
                    mesh=None) -> None:
    """Assert the sharded lowering (on ``mesh``) matches the single-device
    lowering on ``env`` within the reference's fp tolerance.  Two
    reassociations are expected and bounded, nothing else may differ: a
    psum sums device partials where the serial contraction sums in one
    pass, and even gather-only plans run matmuls at *local* shapes, where
    cuBLAS (or a kernel's split) may pick a different, equally valid,
    contraction order.  Genuine sharding bugs (wrong shard, missing
    collective) produce O(1) errors, orders of magnitude past the gate."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    single = lower(compiled, jit=False, device=device)(env)
    shard = lower(compiled, jit=False, device=device, sharding=sharding,
                  mesh=mesh)(env)
    assert_outputs_close(shard, single, rtol=rtol, atol=atol,
                         what="of the sharded lowering diverged beyond the "
                              "fp-reassociation tolerance")


def verify_routing(compiled: CompiledDataflow, env: dict,
                   rtol: float = 1e-5, atol: float = 1e-5,
                   device=None) -> LoweredProgram:
    """Assert the pattern-routed lowering matches the un-routed generic
    lowering on ``env``.  Returns the routed program."""
    generic = lower(compiled, jit=False, use_registered_kernels=False,
                    device=device)
    routed = lower(compiled, jit=False, use_registered_kernels=True,
                   device=device)
    assert_outputs_close(routed(env), generic(env), rtol=rtol, atol=atol,
                         what="from the kernel-routed path diverged from "
                              "the generic path")
    return routed


__all__ = ["FusionGroup", "LOWER_CACHE_STATS", "LoweredProgram",
           "assert_outputs_close", "clear_lower_cache", "fusion_groups",
           "lower", "lower_artifact", "oracle_outputs", "place_sharding",
           "register_group_kernel", "verify_lowering", "verify_routing",
           "verify_sharding"]
