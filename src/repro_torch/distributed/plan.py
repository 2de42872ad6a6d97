"""Pure-data sharding plan: mesh shape + per-buffer placements + the
collective schedule that stitches the shards back together.

The PyTorch port's copy of ``repro/distributed/plan.py``: the same
classes, the same dictionaries and the same :meth:`ShardingPlan.digest`,
byte for byte, because a plan's digest enters the lowering memo key and
the v1.4 artifact ``sharding`` section, and artifacts cross between the
two packages.  It imports nothing but the standard library.  Building a
plan from a graph lives in :mod:`repro_torch.distributed.partition`;
running one lives in :mod:`repro_torch.distributed.collectives` and the
lockstep interpreter of :mod:`repro_torch.core.lowering`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

__all__ = [
    "MeshSpec",
    "ShardSpec",
    "CollectiveStep",
    "ShardingPlan",
    "COLLECTIVE_KINDS",
]

# Typed collective vocabulary.  ``via`` on a step records how the plan
# decided to realize it (bandwidth-optimal decompositions are a *plan*
# decision, not an execution-time one, so artifacts replay identically):
#   all_gather      via "direct" (concatenate) or "ring" (neighbour hops)
#   psum            via "direct" (sum in position order) or "rs_ag"
#                   (reduce_scatter + all_gather, 2(n-1)/n bytes per link)
#   reduce_scatter  emitted only as a component of an "rs_ag" psum today
#   ppermute        the ring building block; emitted via all_gather "ring"
COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "psum", "ppermute")


@dataclass(frozen=True)
class MeshSpec:
    """Device-mesh shape as pure data: ``(("data", 4), ("model", 2))``.

    The :class:`~repro_torch.launch.mesh.Mesh` (which pins a
    ``torch.device`` to every position) is only built at execution time —
    see ``launch.mesh.mesh_from_spec`` and ``make_debug_mesh`` — so a plan
    made on the CPU round-trips through an artifact and reloads on any
    machine that places it.
    """

    axes: tuple[tuple[str, int], ...]

    def __post_init__(self):
        axes = tuple((str(n), int(s)) for n, s in self.axes)
        object.__setattr__(self, "axes", axes)
        names = [n for n, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names: {names}")
        for n, s in axes:
            if s < 1:
                raise ValueError(f"mesh axis {n!r} has size {s}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def size(self) -> int:
        total = 1
        for _, s in self.axes:
            total *= s
        return total

    def axis_size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(f"no mesh axis {name!r} in {self.names}")

    @classmethod
    def of(cls, mesh) -> "MeshSpec":
        """Coerce the port's :class:`~repro_torch.launch.mesh.Mesh` (its
        ``.spec``), any mesh with a ``.shape`` mapping of axis name to size
        (the reference's jax ``Mesh`` too), or an existing ``MeshSpec``."""
        if isinstance(mesh, cls):
            return mesh
        spec = getattr(mesh, "spec", None)
        if isinstance(spec, cls):
            return spec
        shape = getattr(mesh, "shape", None)
        if hasattr(shape, "items"):
            return cls(tuple((str(k), int(v)) for k, v in shape.items()))
        raise TypeError(f"cannot build MeshSpec from {type(mesh).__name__}")

    def to_dict(self) -> dict:
        return {"axes": [[n, s] for n, s in self.axes]}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        return cls(tuple((n, s) for n, s in d["axes"]))


@dataclass(frozen=True)
class ShardSpec:
    """Per-buffer placement: one mesh-axis name (or None) per buffer dim.

    The *local* array on each device is the global shape with every
    sharded dim divided by its axis size; a spec of all-None means the
    buffer is fully replicated.
    """

    dims: tuple[str | None, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "dims",
            tuple(None if d is None else str(d) for d in self.dims))
        named = [d for d in self.dims if d is not None]
        if len(set(named)) != len(named):
            raise ValueError(f"mesh axis used on two dims: {self.dims}")

    @property
    def is_replicated(self) -> bool:
        return all(d is None for d in self.dims)

    def shard_factor(self, mesh: MeshSpec) -> int:
        f = 1
        for d in self.dims:
            if d is not None:
                f *= mesh.axis_size(d)
        return f

    def local_shape(self, shape: tuple[int, ...], mesh: MeshSpec) -> tuple:
        out = []
        for size, d in zip(shape, self.dims):
            out.append(size if d is None else size // mesh.axis_size(d))
        return tuple(out)

    @classmethod
    def replicated(cls, ndim: int) -> "ShardSpec":
        return cls((None,) * ndim)

    def to_dict(self) -> dict:
        return {"dims": list(self.dims)}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardSpec":
        return cls(tuple(d["dims"]))


@dataclass(frozen=True)
class CollectiveStep:
    """One inter-device edge of the TransferPlan, lowered to a typed
    collective.  ``where``/``task`` anchor it in the schedule: gathers run
    *before* the first consumer that needs the full buffer, reductions
    run *after* the producer that left partial sums.

    Buffer sizing reuses the FIFO-depth machinery: ``depth`` slots of
    ``chunk_bytes`` each (a ring step holds one in-flight chunk per slot,
    exactly like a FIFO holds ``fifo_depth`` tiles), and ``channel`` is
    the HBM channel the off-chip pass assigned to the staged buffer.
    """

    kind: str                 # one of COLLECTIVE_KINDS
    buffer: str               # env/scope key the step rewrites
    axis: str                 # mesh axis reduced/gathered over
    task: str                 # schedule anchor (task name)
    where: str = "after"      # "before" (pre-consumer) | "after" (post-producer)
    dim: int = 0              # buffer dim gathered/scattered (AG/RS)
    bytes: int = 0            # per-device payload
    chunk_bytes: int = 0      # one ring/scatter chunk
    depth: int = 1            # FIFO-depth slots backing the transfer
    channel: int = -1         # HBM channel from the TransferPlan (-1: none)
    via: str = "direct"       # "direct" | "ring" | "rs_ag"

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}")
        if self.where not in ("before", "after"):
            raise ValueError(f"bad collective anchor {self.where!r}")

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "buffer": self.buffer, "axis": self.axis,
            "task": self.task, "where": self.where, "dim": self.dim,
            "bytes": self.bytes, "chunk_bytes": self.chunk_bytes,
            "depth": self.depth, "channel": self.channel, "via": self.via,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CollectiveStep":
        return cls(**{k: d[k] for k in (
            "kind", "buffer", "axis", "task", "where", "dim", "bytes",
            "chunk_bytes", "depth", "channel", "via")})


@dataclass(frozen=True)
class ShardingPlan:
    """The complete multi-device story for one compiled design."""

    mesh: MeshSpec
    strategy: str                                  # replicate|dp|tp|dp_tp
    specs: dict[str, ShardSpec] = field(default_factory=dict)
    steps: tuple[CollectiveStep, ...] = ()
    estimated_cycles: float = 0.0                  # per-device, collectives in

    def spec_of(self, buffer: str, ndim: int) -> ShardSpec:
        return self.specs.get(buffer, ShardSpec.replicated(ndim))

    @property
    def collective_bytes(self) -> int:
        return sum(s.bytes for s in self.steps)

    def digest(self) -> str:
        """Stable content digest — enters the lowering memo key (the same
        role ``RoutingCostParams.digest`` plays for routing state)."""
        canon = (
            self.mesh.axes, self.strategy,
            tuple(sorted((k, v.dims) for k, v in self.specs.items())),
            tuple((s.kind, s.buffer, s.axis, s.task, s.where, s.dim,
                   s.via) for s in self.steps),
        )
        return hashlib.sha256(repr(canon).encode()).hexdigest()[:16]

    def summary(self) -> str:
        sharded = sum(1 for s in self.specs.values() if not s.is_replicated)
        kinds = {}
        for s in self.steps:
            kinds[s.kind] = kinds.get(s.kind, 0) + 1
        ks = ",".join(f"{k}x{v}" for k, v in sorted(kinds.items())) or "none"
        return (f"sharding[{self.strategy}] mesh="
                + "x".join(f"{n}:{s}" for n, s in self.mesh.axes)
                + f" {sharded}/{len(self.specs)} buffers sharded"
                + f" collectives={ks} ({self.collective_bytes} B)")

    def to_dict(self) -> dict:
        return {
            "mesh": self.mesh.to_dict(),
            "strategy": self.strategy,
            "specs": {k: v.to_dict() for k, v in sorted(self.specs.items())},
            "steps": [s.to_dict() for s in self.steps],
            "estimated_cycles": self.estimated_cycles,
            "digest": self.digest(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShardingPlan":
        plan = cls(
            mesh=MeshSpec.from_dict(d["mesh"]),
            strategy=d["strategy"],
            specs={k: ShardSpec.from_dict(v)
                   for k, v in d.get("specs", {}).items()},
            steps=tuple(CollectiveStep.from_dict(s)
                        for s in d.get("steps", [])),
            estimated_cycles=float(d.get("estimated_cycles", 0.0)),
        )
        want = d.get("digest")
        if want and want != plan.digest():
            raise ValueError(
                f"sharding plan digest mismatch: {want} != {plan.digest()}")
        return plan
