"""The LM-training device meshes over ``torch.distributed`` and the SU3
lattice's (host, device) topology on one card (port of
``repro.launch.mesh``).

:func:`make_mesh` and :func:`make_production_mesh` are the reference's
LM-training meshes: a ``torch.distributed.device_mesh.DeviceMesh`` over the
running process group with named axes (``("data", "model")`` or ``("pod",
"data", "model")``).  The group comes first, from
:func:`init_distributed`: NCCL over the cards (the default) or, when the
caller asks for the CPU, gloo.  A mesh whose size is not the world's is
refused; nothing falls back to another backend or device.

The paper's NUMA lesson (§4: data must be first-touched by the socket that
streams it) becomes, on a fleet, *each host builds the lattice slab it
owns*.  :class:`MeshSpec` carries that topology into
``core.su3.plan.build_plan``: the lattice splits along t into ``hosts``
contiguous slabs, and the plan runs its multi-slab schedules (first-touch
init per slab, the exchange / interior / boundary stencil and CG passes,
the depth-2 ring) over them.

:meth:`MeshSpec.resolve` gives a :class:`SlabMesh`, not a
``jax.sharding.Mesh``.  With no process group running (and no ``group``
given) every slab lives in one tensor on the one device: slab ``h`` is the
site range ``host_site_ranges(...)[h]``, and "devices per host" all share
that device, as the reference's short-pool oversubscription does.  With a
process group (NCCL over the cards, one card a rank; gloo on the CPU) the
mesh is *ranked*: rank ``r`` of ``world`` owns the ``hosts // world``
contiguous slabs ``r * hosts // world ...`` and holds only those, on its
own card; the plan exchanges the +-t faces between ranks point to point.
``devices_per_host`` keeps its meaning on each rank's card.

A mesh's :attr:`SlabMesh.devices` are the devices its whole-lattice batch
blocks run on (``distributed.sharding.lattice_batch_blocks``: request
batches and megakernel slot tables, one block of whole lattices per mesh
position, host-major).  Without a group that is every position: the
process's first ``n_devices`` cards when it sees that many and was given no
device index, else the one device repeated, as the reference oversubscribes
a short pool (``resolve(devices=...)`` names them explicitly).  A ranked
mesh keeps one card per rank: its positions all name it.

:func:`host_devices` and :func:`host_submesh` are the reference's per-host
device blocks over a list of ``torch.device`` objects (the process's cards by
default): host ``h`` owns the contiguous block ``devices[h * dph : (h + 1)
* dph]``, and on a list shorter than ``hosts * dph`` every host shares its
head.  ``serve.su3.SU3Service`` places host ``h``'s runners on them.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch

from repro_torch.distributed.sharding import rank_slabs

# Axis names of the lattice (host, device) mesh; a one-slab mesh has the
# single "sites" axis (the names the sharding helpers read).
SITE_AXIS = "sites"
HOST_AXIS = "hosts"
DEVICE_AXIS = "devices"

# The reference's production shapes: one pod of 16 x 16, two pods of them.
PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device: torch.device | str | None) -> str:
    kind = torch.device("cuda" if device is None else device).type
    if kind not in _BACKENDS:
        raise ValueError(f"a mesh runs on cuda (NCCL) or cpu (gloo), not {kind!r}")
    return kind


def init_distributed(
    device: torch.device | str | None = None, *, init_method: str | None = None,
    rank: int | None = None, world_size: int | None = None,
) -> torch.device:
    """Start the default process group and return this rank's device.

    Args:
        device: ``None`` or ``"cuda"`` (NCCL, one card per rank: the card
            of the rank's ``LOCAL_RANK``) or ``"cpu"`` (gloo).
        init_method: ``None`` reads ``torch.distributed.run``'s environment
            (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
            ``"file:///path"`` rendezvous through a file, with ``rank`` and
            ``world_size`` given.
        rank, world_size: this process's rank and the world's size (read
            from the environment when not given).

    Raises:
        RuntimeError: NCCL without CUDA, or with more ranks on this host
            than cards; a group already running on another backend.
    """
    kind = _device_type(device)
    backend = _BACKENDS[kind]
    dist = torch.distributed
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA; pass device='cpu' for gloo")
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise RuntimeError(f"local rank {local_rank} has no card: NCCL takes one card a "
                               f"rank, and this host has {cards}")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group is running; {kind} needs {backend}")
        return dev
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise RuntimeError("no rendezvous: run under torch.distributed.run, or pass "
                           "init_method='file:///path' with rank and world_size")
    kwargs = {"device_id": dev} if kind == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: torch.device | str | None = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    running process group, on the cards (``device`` None or ``"cuda"``,
    NCCL) or the CPU (``"cpu"``, gloo).

    Raises:
        ValueError: ``shape`` and ``axes`` differ in length, or the mesh's
            size is not the world's.
        RuntimeError: no process group, or one on the other backend.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    kind = _device_type(device)
    dist = torch.distributed
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    if dist.get_backend() != _BACKENDS[kind]:
        raise RuntimeError(f"a {kind} mesh needs {_BACKENDS[kind]}, the group runs "
                           f"{dist.get_backend()}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} devices, the world has "
                         f"{world} ranks")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def rank_device(mesh: Any) -> torch.device:
    """This rank's device on a ``DeviceMesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_production_mesh(*, multi_pod: bool = False, device: torch.device | str | None = None):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device=device)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device=device)


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """A resolved lattice mesh: ``hosts`` t-slabs, on one device or over the
    ranks of a process group.

    Attributes:
        hosts: slab count (1 = the single-slab plan).
        devices_per_host: devices per slab: the lattice's sites stay on
            ``device``; whole-lattice batch blocks go to ``devices``.
        device: the card (or the CPU) that holds this process's slabs.
        rank, world: this process's rank in ``group`` and the group's size
            (0 and 1 without a group).
        group: the process group the slabs are spread over; ``None`` keeps
            every slab in this process (the one-process plan).
        devices: the devices of the mesh positions this process holds,
            host-major: ``n_devices`` of them without a group, ``n_devices
            // world`` (this rank's card each) on ranks; empty means
            ``device`` repeated.
    """

    hosts: int
    devices_per_host: int
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    devices: tuple = ()

    def __post_init__(self) -> None:
        rank_slabs(self.rank, self.hosts, self.world)  # refuses an uneven split
        held = self.n_devices // self.world
        devices = tuple(torch.device(d) for d in self.devices) or (self.device,) * held
        if len(devices) != held:
            raise ValueError(f"a mesh of {self.n_devices} devices over {self.world} "
                             f"process(es) holds {held} here, got {len(devices)} devices")
        if self.is_ranked and any(d != self.device for d in devices):
            raise ValueError(f"a ranked mesh keeps one card per rank ({self.device}), "
                             f"got {devices}")
        object.__setattr__(self, "devices", devices)

    @property
    def n_devices(self) -> int:
        return self.hosts * self.devices_per_host

    @property
    def is_ranked(self) -> bool:
        """The slabs are spread over the ranks of a process group."""
        return self.group is not None

    @property
    def slabs(self) -> range:
        """The slabs this rank owns (every slab without a group)."""
        return rank_slabs(self.rank, self.hosts, self.world)

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


def _cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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

    def resolve(self, device: torch.device | str | None = None, *,
                group: Any = None, devices: list | None = None) -> SlabMesh:
        """The slab mesh on ``device``: ``None`` is the CUDA device (raises
        without CUDA); pass ``"cpu"`` for the plain versions.

        Without a group the mesh's batch blocks run on ``devices`` (its
        first ``n_devices``): by default the process's first ``n_devices``
        cards when ``device`` is the card with no index and the process sees
        that many, else ``device`` repeated (the reference's
        oversubscription).  With a running process group (or an explicit
        ``group``) the mesh is ranked: this process's rank owns ``hosts //
        world`` slabs, on its own card (the current CUDA device; NCCL) or on
        the CPU (gloo), and so do its batch blocks.

        Raises:
            ValueError: ``hosts`` is not a multiple of the world's size;
                ``devices`` holds fewer than ``n_devices``, or is given to a
                ranked mesh.
            RuntimeError: the group's backend is not the device's (a card
                needs NCCL, the CPU gloo).
        """
        from repro_torch.core.su3.plan import resolve_device

        dev = resolve_device(device)
        dist = torch.distributed
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        n = self.hosts * self._dph
        if group is None:
            if devices is None and dev.type == "cuda" and dev.index is None and n > 1:
                cards = _cards()
                devices = cards if len(cards) >= n else None
            if devices is not None and len(devices) < n:
                raise ValueError(f"MeshSpec(hosts={self.hosts}, devices_per_host={self._dph}) "
                                 f"needs {n} devices, got {len(devices)}")
            return SlabMesh(self.hosts, self._dph, dev,
                            devices=tuple(devices[:n]) if devices is not None else ())
        if devices is not None:
            raise ValueError("a ranked mesh keeps one card per rank: pass no device list")
        backend = dist.get_backend(group)
        if dev.type not in _BACKENDS or backend != _BACKENDS[dev.type]:
            raise RuntimeError(f"slabs on {dev.type} ranks need "
                               f"{_BACKENDS.get(dev.type, 'a cuda or cpu device')}, "
                               f"the group runs {backend}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return SlabMesh(self.hosts, self._dph, dev, dist.get_rank(group),
                        dist.get_world_size(group), group)

    def _dph_of(self, n_available: int) -> int:
        """The reference's devices per host over a pool of ``n_available``."""
        if self.devices_per_host:
            return self.devices_per_host
        return max(n_available // self.hosts, 1)

    def host_devices(self, host: int, devices: list | None = None) -> list:
        """Devices owned by ``host`` (oversubscribed when the pool is short).

        Host ``h``'s contiguous block of ``devices`` (default: the
        process's cards); on a pool smaller than the spec every host shares
        the head of the list, as the reference does.

        Raises:
            ValueError: ``host`` is out of range.
            RuntimeError: the pool is empty (no card and no list given).
        """
        if not 0 <= host < self.hosts:
            raise ValueError(f"host {host} out of range [0, {self.hosts})")
        devices = list(devices if devices is not None else _cards())
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')]")
        dph = self._dph_of(len(devices))
        if len(devices) >= self.hosts * dph:
            return devices[host * dph:(host + 1) * dph]
        return devices[:dph]

    def host_submesh(self, host: int, devices: list | None = None) -> SlabMesh:
        """The one-slab mesh of ``host``'s block (the reference's 1-D
        ``("sites",)`` mesh over it): its runners plan on the block's first
        device, ``devices_per_host`` counts the block, and their batch
        blocks run on every device of it."""
        block = [torch.device(d) for d in self.host_devices(host, devices)]
        return SlabMesh(1, len(block), block[0], devices=tuple(block))

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
