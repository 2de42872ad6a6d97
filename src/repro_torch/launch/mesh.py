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

Every function here builds a mesh when it is called; importing the module
touches no device.
"""

from __future__ import annotations

from repro_torch.distributed.plan import MeshSpec

__all__ = ["Mesh", "dp_axes", "make_debug_mesh", "make_production_mesh",
           "mesh_from_spec", "model_axis"]


class Mesh:
    """A :class:`MeshSpec` and one ``torch.device`` per position, in the
    spec's row-major order (the last axis varies fastest).  ``.shape`` (an
    axis name -> size mapping) and ``.axis_names`` read as the reference's
    jax ``Mesh`` does, so :meth:`MeshSpec.of` and the sharding rules take
    either."""

    def __init__(self, spec, devices):
        import torch
        self.spec = MeshSpec.of(spec)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.spec.size:
            raise ValueError(f"mesh {self._axes_text()} has {self.spec.size} "
                             f"positions, got {len(self.devices)} devices")

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
        by_rest: dict[tuple, list[int]] = {}
        for p in range(self.size):
            c = self.coords(p)
            rest = tuple(v for k, v in c.items() if k != axis)
            by_rest.setdefault(rest, []).append(p)
        return list(by_rest.values())

    @property
    def distinct_devices(self) -> tuple:
        """The devices the positions sit on, each once, in position
        order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        where = ", ".join(str(d) for d in self.distinct_devices)
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
    through) on the first ``spec.size`` CUDA cards, one a position.  This
    is where a :class:`ShardingPlan` loaded from an artifact meets
    devices; with fewer cards it raises (a one-card host re-shards onto
    :func:`make_debug_mesh` instead)."""
    if isinstance(spec, Mesh):
        return spec
    return _cards_for(MeshSpec.of(spec), "sharding plan")


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
