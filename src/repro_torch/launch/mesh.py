"""Device meshes of the PyTorch port: a mesh shape and a device for every
position.

The port's counterpart of ``repro/launch/mesh.py``.  The reference runs a
sharded program as ``shard_map`` under ``jax.jit``: one process drives
every position of the mesh (single-controller SPMD), and its CI forces a
4 x 2 mesh onto 8 host devices of one CPU.  The port keeps that execution
model: a :class:`Mesh` is a :class:`~repro_torch.distributed.plan.
MeshSpec` plus a ``torch.device`` for every position, and the sharded
lowering runs its step list in lockstep over the positions from one
process.  On the CPU every position is the CPU; on one card every position
is that card (:func:`make_debug_mesh`); on a host with enough cards the
positions are distinct cards (:func:`mesh_from_spec`).

A mesh may also be split over ranks, one process a card
(:mod:`repro_torch.launch.ranks`): :func:`rank_mesh`, called by every
rank of a ``torch.distributed`` process group, deals the positions to the
ranks in contiguous row-major blocks.  Each rank holds, computes and
captures only its own positions (``local_positions``); what it needs of
the others comes through the group's ``all_gather``
(:func:`repro_torch.distributed.collectives.exchange`).  A :class:`Mesh`
built without a process group is single-process, as before.

Every function here builds a mesh when it is called; importing the module
touches no device.
"""

from __future__ import annotations

from repro_torch.distributed.plan import MeshSpec

__all__ = ["Mesh", "dp_axes", "make_debug_mesh", "make_production_mesh",
           "mesh_from_spec", "model_axis", "rank_mesh"]


class Mesh:
    """A :class:`MeshSpec` and one ``torch.device`` per position, in the
    spec's row-major order (the last axis varies fastest).  ``.shape`` (an
    axis name -> size mapping) and ``.axis_names`` read as the reference's
    jax ``Mesh`` does, so :meth:`MeshSpec.of` and the sharding rules take
    either.

    ``ranks`` (one a position) splits the mesh over the ranks of a
    process group (:func:`rank_mesh` builds it): this process is rank
    ``rank`` and holds the positions whose rank it is; ``groups`` maps a
    tuple of ranks to the process group of those ranks.  Without ranks
    every position is this process's."""

    def __init__(self, spec, devices, *, ranks=None, rank: int = 0,
                 groups=None):
        import torch
        self.spec = MeshSpec.of(spec)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.spec.size:
            raise ValueError(f"mesh {self._axes_text()} has {self.spec.size} "
                             f"positions, got {len(self.devices)} devices")
        self.ranks = (tuple(ranks) if ranks is not None
                      else (rank,) * self.spec.size)
        self.rank = rank
        self.world = len(set(self.ranks))
        self.rank_groups = dict(groups or {})
        self.local_positions = tuple(p for p, r in enumerate(self.ranks)
                                     if r == rank)

    @property
    def distributed(self) -> bool:
        """Whether the positions are split over the ranks of a process
        group (a :func:`rank_mesh`)."""
        return bool(self.rank_groups)

    def rank_of(self, position: int) -> int:
        return self.ranks[position]

    def is_local(self, position: int) -> bool:
        return self.ranks[position] == self.rank

    def process_group(self, ranks: tuple):
        """The process group of ``ranks`` (sorted), made when the mesh was
        dealt."""
        return self.rank_groups[tuple(ranks)]

    @property
    def local_devices(self) -> tuple:
        """The devices of this process's positions, each once."""
        return tuple(dict.fromkeys(self.devices[p]
                                   for p in self.local_positions))

    def _axes_text(self) -> str:
        return "x".join(f"{n}:{s}" for n, s in self.spec.axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.spec.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.spec.names

    @property
    def size(self) -> int:
        return self.spec.size

    def coords(self, position: int) -> dict[str, int]:
        """The position's coordinate along every axis."""
        out = {}
        for name, size in reversed(self.spec.axes):
            position, out[name] = divmod(position, size)
        return {name: out[name] for name in self.spec.names}

    def groups(self, axis: str) -> list[list[int]]:
        """The positions that a collective over ``axis`` joins: one group
        for each coordinate of the other axes, each in order along
        ``axis``."""
        self.spec.axis_size(axis)               # KeyError for a bad axis
        return self.groups_over((axis,))

    def groups_over(self, axes: tuple) -> list[list[int]]:
        """The positions that share every coordinate but those of
        ``axes``: one group for each coordinate of the other axes."""
        by_rest: dict[tuple, list[int]] = {}
        for p in range(self.size):
            c = self.coords(p)
            rest = tuple(v for k, v in c.items() if k not in axes)
            by_rest.setdefault(rest, []).append(p)
        return list(by_rest.values())

    @property
    def distinct_devices(self) -> tuple:
        """The devices the positions sit on, each once, in position
        order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        where = ", ".join(str(d) for d in self.distinct_devices)
        if self.distributed:
            return (f"Mesh({self._axes_text()} on {where}, rank "
                    f"{self.rank} of {self.world})")
        return f"Mesh({self._axes_text()} on {where})"


def _card(device):
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so positions compare equal to the tensors placed on them."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` with every position on one
    device: the card unless the caller asks for the CPU (``device="cpu"``;
    see :func:`repro_torch.api.resolve_device`).  The port's counterpart
    of the reference's debug mesh over forced host devices: a 4 x 2 mesh
    runs its eight positions one after another on that device."""
    from repro_torch.api import resolve_device
    spec = MeshSpec(tuple(zip(axes, shape)))
    return Mesh(spec, [_card(resolve_device(device))] * spec.size)


def _cards_for(spec: MeshSpec, what: str) -> Mesh:
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < spec.size:
        raise RuntimeError(
            f"{what} needs {spec.size} devices for mesh "
            + "x".join(f"{n}:{s}" for n, s in spec.axes)
            + f", have {have} CUDA devices — place every position on one "
            f"device with repro_torch.launch.mesh.make_debug_mesh, or run "
            f"on a host with enough cards")
    return Mesh(spec, [torch.device("cuda", i) for i in range(spec.size)])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes — (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") — one card a
    position; raises with fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _cards_for(MeshSpec(tuple(zip(axes, shape))), "the production mesh")


def mesh_from_spec(spec) -> Mesh:
    """Place a pure-data :class:`MeshSpec` (or a :class:`Mesh`, passed
    through) on devices.  Inside a process group it is the group's
    :func:`rank_mesh`; otherwise the first ``spec.size`` CUDA cards, one a
    position.  This is where a :class:`ShardingPlan` loaded from an
    artifact meets devices; with fewer cards it raises (a one-card host
    re-shards onto :func:`make_debug_mesh` instead)."""
    if isinstance(spec, Mesh):
        return spec
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return rank_mesh(spec)
    return _cards_for(MeshSpec.of(spec), "sharding plan")


def _axis_subsets(names: tuple) -> list:
    """Every non-empty subset of the axis names, in a fixed order."""
    out = []
    for mask in range(1, 1 << len(names)):
        out.append(tuple(n for i, n in enumerate(names) if mask >> i & 1))
    return out


def rank_mesh(spec, *, device=None) -> Mesh:
    """The mesh ``spec`` split over the ranks of the current
    ``torch.distributed`` process group, one process a card
    (:func:`repro_torch.launch.ranks.spawn` starts them): the positions
    are dealt to the ranks in contiguous row-major blocks of ``spec.size
    / world``, so a 4 x 2 (data, model) mesh over 4 ranks gives each rank
    one data coordinate with both model positions on its card.  Every
    rank must call it, in the same order as its other collectives: it
    makes the process groups its collectives run over (one for each set
    of ranks a group of positions along some axes spans) and learns each
    rank's device.  ``device`` is this rank's: by default where
    :func:`~repro_torch.launch.ranks.spawn` put the rank (its card, the
    CPU only when spawn was given ``device="cpu"``), whatever the backend;
    in a process group spawn did not start, the card (there is no
    fallback to the CPU)."""
    import torch.distributed as dist

    from repro_torch.api import resolve_device
    from repro_torch.launch.ranks import rank_device
    if isinstance(spec, Mesh):
        spec = spec.spec
    if isinstance(spec, dict):
        spec = MeshSpec(tuple(spec.items()))
    spec = MeshSpec.of(spec)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("rank_mesh needs a torch.distributed process "
                           "group: run it inside repro_torch.launch.ranks."
                           "spawn")
    world, rank = dist.get_world_size(), dist.get_rank()
    if spec.size % world:
        raise ValueError(f"{world} ranks do not divide mesh "
                         + "x".join(f"{n}:{s}" for n, s in spec.axes)
                         + f" ({spec.size} positions)")
    if device is None:
        device = rank_device()
    here = _card(resolve_device(device))
    every: list = [None] * world
    dist.all_gather_object(every, str(here))
    per = spec.size // world
    ranks = [p // per for p in range(spec.size)]
    devices = [every[r] for r in ranks]
    mesh = Mesh(spec, devices, ranks=ranks, rank=rank,
                groups={tuple(range(world)): dist.group.WORLD})
    sets = []
    for axes in _axis_subsets(mesh.axis_names):
        for group in mesh.groups_over(axes):
            rs = tuple(sorted({ranks[p] for p in group}))
            if 1 < len(rs) < world and rs not in sets:
                sets.append(rs)
    for rs in sets:                 # every rank, the same order
        mesh.rank_groups[rs] = dist.new_group(list(rs))
    return mesh


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
