"""The SU3 lattice's (host, device) topology on one card (port of
:class:`repro.launch.mesh.MeshSpec`).

The paper's NUMA lesson (§4: data must be first-touched by the socket that
streams it) becomes, on a fleet, *each host builds the lattice slab it
owns*.  :class:`MeshSpec` carries that topology into
``core.su3.plan.build_plan``: the lattice splits along t into ``hosts``
contiguous slabs, and the plan runs its multi-slab schedules (first-touch
init per slab, the exchange / interior / boundary stencil and CG passes,
the depth-2 ring) over them.

On one card every slab lives in one tensor on the one device: slab ``h`` is
the site range ``host_site_ranges(...)[h]``, and "devices per host" all
share that device, as the reference's short-pool oversubscription does.
:meth:`MeshSpec.resolve` gives a :class:`SlabMesh` (the host count, the
devices per host, the device), not a ``jax.sharding.Mesh``.

The reference's LM-training meshes (``make_production_mesh``,
``make_mesh``) have no counterpart: the port's LM path runs on one card.
"""
from __future__ import annotations

import dataclasses

import torch

# Axis names of the lattice (host, device) mesh; a one-slab mesh has the
# single "sites" axis (the names the sharding helpers read).
SITE_AXIS = "sites"
HOST_AXIS = "hosts"
DEVICE_AXIS = "devices"


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """A resolved lattice mesh: ``hosts`` t-slabs of one tensor on ``device``.

    Attributes:
        hosts: slab count (1 = the single-slab plan).
        devices_per_host: simulated devices per slab; all share ``device``.
        device: the card (or the CPU) that holds every slab.
    """

    hosts: int
    devices_per_host: int
    device: torch.device

    @property
    def n_devices(self) -> int:
        return self.hosts * self.devices_per_host

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.hosts == 1:
            return (SITE_AXIS,)
        return (HOST_AXIS, DEVICE_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        if self.hosts == 1:
            return {SITE_AXIS: self.devices_per_host}
        return {HOST_AXIS: self.hosts, DEVICE_AXIS: self.devices_per_host}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Topology of the lattice mesh: ``hosts`` x ``devices_per_host``.

    Attributes:
        hosts: number of slabs (hosts in a fleet).  ``1`` is the single-slab
            plan exactly.
        devices_per_host: devices each host contributes; ``0`` (default)
            infers one, the card's only device.

    Slab ``h`` owns the contiguous site range ``[h * S/hosts, (h + 1) *
    S/hosts)`` of the padded lattice.
    """

    hosts: int = 1
    devices_per_host: int = 0

    def __post_init__(self) -> None:
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.devices_per_host < 0:
            raise ValueError(
                f"devices_per_host must be >= 0 (0 = infer), got {self.devices_per_host}"
            )

    @property
    def _dph(self) -> int:
        return self.devices_per_host or 1

    def resolve(self, device: torch.device | str | None = None) -> SlabMesh:
        """The slab mesh on ``device``: ``None`` is the CUDA device (raises
        without CUDA); pass ``"cpu"`` for the plain versions."""
        from repro_torch.core.su3.plan import resolve_device

        return SlabMesh(self.hosts, self._dph, resolve_device(device))

    @property
    def is_multi_host(self) -> bool:
        return self.hosts > 1

    def n_devices(self) -> int:
        return self.hosts * self._dph

    def describe(self) -> str:
        dph = self.devices_per_host or "auto"
        return f"{self.hosts}h x {dph}d"

    @classmethod
    def single_host(cls) -> "MeshSpec":
        """One slab, the card's device."""
        return cls(hosts=1)

    @classmethod
    def simulated(cls, hosts: int, devices_per_host: int = 0) -> "MeshSpec":
        """The same as the constructor, named so call sites read as a
        simulated fleet."""
        return cls(hosts=hosts, devices_per_host=devices_per_host)
