"""Halo and boundary geometry of a sharded SU3 lattice, and the LM
sharding rules (port of ``repro.distributed.sharding``).

The LM half (:class:`LogicalMesh`, :class:`MeshRules`,
:func:`default_rules`, :func:`resolve_spec`, :func:`state_spec_for`) is the
reference's rule resolver over a dict of axis sizes: which mesh axes divide
each dim of a parameter or a state leaf.  The dry run
(``launch/dryrun.py``) reads the per-device sizes from it.
:func:`param_placements`, :func:`opt_state_placements` and
:func:`batch_placements` turn the same resolution into DTensor placements,
one ``Shard``/``Replicate`` per mesh dim (the counterparts of the
reference's ``param_shardings``, ``opt_state_shardings`` and
``batch_shardings``), and :func:`distribute_tree` and
:func:`distribute_batch` place full leaves on a ``DeviceMesh``
(``launch/mesh.py``'s ``make_mesh``) by them.  :func:`state_placements`
(the reference's ``state_shardings``) does the same for a decode state by
:func:`state_spec_for`, and :func:`distribute_state` makes a zero state
at those placements, each rank allocating its own shard only.

Pure arithmetic: the L^4 lattice splits along its outermost (t) dimension
into ``n_shards`` contiguous slabs, and a nearest-neighbour stencil needs
the +-t faces of each slab from its neighbours.  The stencil's neighbour
tables (``plan.stencil_neighbor_tables``) read the boundary ranges from
here, and ``ExecutionPlan.stencil_halo`` prices the vector-field exchange.

Where the reference shards arrays with ``NamedSharding`` over a
``jax.sharding.Mesh``, the port indexes slab ranges directly: a
:class:`repro_torch.launch.mesh.SlabMesh` names the slab count, and
:func:`host_site_ranges` gives each slab's contiguous site range, which the
plan's first-touch init and its multi-slab schedules index.  On a ranked
mesh rank ``r`` owns the slabs ``rank_slabs(r, hosts, world)`` (the
reference's host-major site spec over ``("hosts", "devices")``):
:func:`slab_owner` names a slab's rank, :func:`rank_site_range` the rank's
contiguous sites, and :func:`t_peers` its -t and +t neighbour ranks.  The
reference's ``lattice_site_spec`` (a ``PartitionSpec``) has no
counterpart: nothing here partitions a tensor.

A batch of whole lattices (request batches, megakernel slot tables) splits
over the mesh's devices instead: :func:`lattice_batch_blocks` gives each mesh
position, host-major, its contiguous range of lattices (the reference's
``ExecutionPlan.lattice_batch_sharding``, read through
``devices_indices_map``), and :func:`device_parts` groups consecutive blocks
that share a device (one tensor holds them).
"""
from __future__ import annotations

import dataclasses
from typing import Any

_GAUGE_WORDS_PER_SITE = 72  # 4 links x 3x3 complex = 36 complex entries = 72 words
VECTOR_WORDS_PER_SITE = 6  # one color 3-vector, planar re+im: the stencil halo

_WORD_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}

# Axis names of the slab mesh (``repro_torch.launch.mesh``): a one-slab mesh
# has the single "sites" axis, a multi-slab mesh ("hosts", "devices").
LATTICE_SITE_AXIS = "sites"
LATTICE_HOST_AXIS = "hosts"
LATTICE_DEVICE_AXIS = "devices"


def lattice_site_axes(mesh: Any) -> tuple[str, ...]:
    """The mesh axes the lattice's site dimension runs over, major first:
    ``("sites",)`` on one slab, ``("hosts", "devices")`` host-major on
    several (one host's sites are contiguous), else every axis in order.

    Args:
        mesh: anything with ``axis_names`` (a ``SlabMesh``).
    """
    names = tuple(mesh.axis_names)
    if LATTICE_SITE_AXIS in names:
        return (LATTICE_SITE_AXIS,)
    if LATTICE_HOST_AXIS in names and LATTICE_DEVICE_AXIS in names:
        return (LATTICE_HOST_AXIS, LATTICE_DEVICE_AXIS)
    return names


def _hosts(mesh: Any) -> int:
    if LATTICE_HOST_AXIS in mesh.axis_names:
        return int(mesh.shape[LATTICE_HOST_AXIS])
    return 1


def lattice_is_multi_host(mesh: Any) -> bool:
    """True when ``mesh`` carries a host axis of size > 1."""
    return _hosts(mesh) > 1


def host_site_ranges(n_sites: int, mesh: Any) -> list[tuple[int, int]]:
    """Each host's contiguous site range ``[(lo, hi), ...]``; one range
    covering everything on a single-slab mesh.

    Raises:
        ValueError: ``n_sites`` does not divide over the hosts (plans pad
            the lattice to a whole number of tiles per device first).
    """
    hosts = _hosts(mesh)
    if n_sites % hosts:
        raise ValueError(
            f"{n_sites} sites do not divide over {hosts} hosts; pad the "
            f"lattice (plans do this) before asking for host ranges"
        )
    per = n_sites // hosts
    return [(h * per, (h + 1) * per) for h in range(hosts)]


def _slabs_per_rank(hosts: int, world: int) -> int:
    if world < 1 or hosts % world:
        raise ValueError(f"hosts={hosts} is not a multiple of the world's {world} ranks: "
                         f"each rank owns hosts / world slabs")
    return hosts // world


def rank_slabs(rank: int, hosts: int, world: int) -> range:
    """The ``hosts // world`` contiguous slabs rank ``rank`` owns.

    Raises:
        ValueError: ``hosts`` is not a multiple of ``world``, or ``rank``
            is out of range.
    """
    per = _slabs_per_rank(hosts, world)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range [0, {world})")
    return range(rank * per, (rank + 1) * per)


def slab_owner(slab: int, hosts: int, world: int) -> int:
    """The rank that owns slab ``slab`` (slabs are dealt host-major, in
    contiguous blocks of ``hosts // world``)."""
    if not 0 <= slab < hosts:
        raise ValueError(f"slab {slab} out of range [0, {hosts})")
    return slab // _slabs_per_rank(hosts, world)


def rank_site_range(n_sites: int, hosts: int, world: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous ``[lo, hi)`` of ``n_sites`` padded sites:
    the union of its slabs' :func:`host_site_ranges`."""
    slabs = rank_slabs(rank, hosts, world)
    if n_sites % hosts:
        raise ValueError(f"{n_sites} sites do not divide over {hosts} hosts")
    per = n_sites // hosts
    return slabs.start * per, slabs.stop * per


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    """One mesh position's share of a whole-lattice batch.

    Attributes:
        index: the position in the mesh, host-major (``h * devices_per_host
            + d``).
        device: where the block's lattices live and its launch runs.
        lo, hi: the block's lattices ``[lo, hi)`` of the whole batch.
    """

    index: int
    device: Any
    lo: int
    hi: int


def lattice_batch_blocks(mesh: Any, batch: int) -> list[BatchBlock]:
    """A batch of ``batch`` whole lattices over ``mesh``'s ``n_devices``
    positions, host-major: position ``i`` holds lattices ``[i * batch / n,
    (i + 1) * batch / n)`` on ``mesh.devices``.  On a ranked mesh only the
    rank's own positions (those of its slabs) are returned.

    Args:
        mesh: a ``SlabMesh`` (``n_devices``, ``devices``, ``rank``,
            ``world``).
        batch: the batch's lattice count, a multiple of ``n_devices``.

    Raises:
        ValueError: ``batch`` is not a positive multiple of ``n_devices``.
    """
    n = mesh.n_devices
    if batch < 1 or batch % n:
        raise ValueError(f"a batch of {batch} lattices does not split into whole lattices "
                         f"over {n} devices: pad it to a multiple of {n}")
    per, held = batch // n, n // mesh.world
    first = mesh.rank * held
    return [BatchBlock(first + j, mesh.devices[j], (first + j) * per, (first + j + 1) * per)
            for j in range(held)]


def device_parts(blocks: list[BatchBlock]) -> list[list[BatchBlock]]:
    """``blocks`` grouped into runs of consecutive blocks on one device: one
    tensor holds each run (the whole batch when every block shares a
    device)."""
    parts: list[list[BatchBlock]] = []
    for blk in blocks:
        if parts and parts[-1][-1].device == blk.device and parts[-1][-1].hi == blk.lo:
            parts[-1].append(blk)
        else:
            parts.append([blk])
    return parts


def t_peers(rank: int, world: int) -> tuple[int, int]:
    """The ranks that own the -t and +t neighbours of rank ``rank``'s
    slabs, with the periodic wrap: at world 2 both are the one other rank,
    at world 1 the rank itself."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range [0, {world})")
    return (rank - 1) % world, (rank + 1) % world


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Boundary geometry of one shard of the lattice.

    The lattice is sharded along t, so a shard of ``sites_per_shard`` sites
    is a slab of t-slices whose boundary toward each neighbour is one L^3
    face.  A nearest-neighbour stencil exchanges both faces per application.

    Attributes:
        L: lattice extent (L^4 sites).
        n_shards: how many contiguous site slabs the lattice splits into.
        word_bytes: storage word width (4 = f32, 2 = bf16 storage plans).
        words_per_site: planar words of the exchanged field per site: 72
            for the gauge field (the default), 6 for the stencil's color
            vectors (:data:`VECTOR_WORDS_PER_SITE`).
        depth: ghost-zone thickness in faces.  depth=2 prices the exchange
            that feeds two stencil applications; the interior/boundary split
            stays depth-1, while ``ghost_ranges`` and the pricing widen.
    """

    L: int
    n_shards: int
    word_bytes: int = 4
    words_per_site: int = _GAUGE_WORDS_PER_SITE
    depth: int = 1

    @property
    def sites_per_shard(self) -> int:
        return self.L**4 // self.n_shards

    @property
    def face_sites(self) -> int:
        """Sites in one boundary face of a slab (an L^3 time-slice)."""
        return self.L**3

    @property
    def boundary_sites(self) -> int:
        """Sites on a shard's surface: two faces, none when unsharded,
        capped at the slab size when the slab is thinner than two faces."""
        if self.n_shards == 1:
            return 0
        return min(2 * self.face_sites, self.sites_per_shard)

    @property
    def halo_sites(self) -> int:
        """Sites one shard sends per exchange: two faces of thickness
        ``depth``, capped at the slab size."""
        if self.n_shards == 1:
            return 0
        return min(2 * self.depth * self.face_sites, self.sites_per_shard)

    @property
    def interior_fraction(self) -> float:
        """Fraction of a shard's sites that touch no boundary."""
        if self.sites_per_shard == 0:
            return 0.0
        return max(0.0, 1.0 - self.boundary_sites / self.sites_per_shard)

    @property
    def halo_bytes_per_exchange(self) -> int:
        """Bytes one shard sends per exchange: the exchanged field's words on
        both depth-thick faces, at storage width."""
        return self.halo_sites * self.words_per_site * self.word_bytes

    # -- interior/boundary/ghost site decomposition ---------------------------
    #
    # All ranges are global half-open site intervals; for every shard,
    # interior_ranges + boundary_ranges partition [lo, hi) exactly.

    def shard_range(self, shard: int) -> tuple[int, int]:
        """Global ``[lo, hi)`` site range of ``shard``'s contiguous slab."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        per = self.sites_per_shard
        return shard * per, (shard + 1) * per

    def _boundary_widths(self) -> tuple[int, int]:
        per, face = self.sites_per_shard, self.face_sites
        b_lo = min(face, per)
        return b_lo, min(face, per - b_lo)

    def boundary_ranges(self, shard: int) -> list[tuple[int, int]]:
        """Ranges of ``shard``'s sites whose +-t neighbours are remote: the
        slab's first and last faces; one range when the slab is thinner than
        two faces; empty when the lattice is unsharded."""
        lo, hi = self.shard_range(shard)
        if self.n_shards == 1:
            return []
        b_lo, b_hi = self._boundary_widths()
        out = [(lo, lo + b_lo)]
        if b_hi:
            out.append((hi - b_hi, hi))
        return out

    def interior_ranges(self, shard: int) -> list[tuple[int, int]]:
        """Ranges of ``shard``'s sites with every neighbour shard-local."""
        lo, hi = self.shard_range(shard)
        if self.n_shards == 1:
            return [(lo, hi)]
        b_lo, b_hi = self._boundary_widths()
        if lo + b_lo >= hi - b_hi:
            return []
        return [(lo + b_lo, hi - b_hi)]

    def ghost_ranges(self, shard: int) -> list[tuple[int, int]]:
        """Remote global site ranges ``shard`` receives per exchange: the
        sites within ``depth`` +-t faces of its boundary, split at the
        periodic seam, without the shard's own sites; merged when
        depth > 1."""
        if self.n_shards == 1:
            return []
        S = self.L**4
        face = self.face_sites
        lo_s, hi_s = self.shard_range(shard)
        out: list[tuple[int, int]] = []
        for b_lo, b_hi in self.boundary_ranges(shard):
            for k in range(1, self.depth + 1):
                for shift in (k * face, -k * face):  # +t then -t neighbours
                    g_lo = (b_lo + shift) % S
                    g_hi = g_lo + (b_hi - b_lo)
                    segs = [(g_lo, g_hi)] if g_hi <= S else [(g_lo, S), (0, g_hi - S)]
                    for lo, hi in segs:
                        cut_lo = max(lo, min(hi, lo_s))
                        cut_hi = max(lo, min(hi, hi_s))
                        if lo < cut_lo:
                            out.append((lo, cut_lo))
                        if cut_hi < hi:
                            out.append((cut_hi, hi))
        ranges = sorted(set(out))
        if self.depth == 1:
            return ranges
        merged: list[tuple[int, int]] = []
        for lo, hi in ranges:
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return merged

    def as_dict(self) -> dict[str, Any]:
        d = {
            "L": self.L,
            "n_shards": self.n_shards,
            "sites_per_shard": self.sites_per_shard,
            "boundary_sites": self.boundary_sites,
            "interior_fraction": round(self.interior_fraction, 4),
            "halo_bytes_per_exchange": self.halo_bytes_per_exchange,
        }
        if self.depth != 1:
            d["depth"] = self.depth
        return d


def halo_spec(
    L: int,
    n_shards: int = 1,
    word_bytes: int | None = None,
    *,
    dtype: str | None = None,
    words_per_site: int = _GAUGE_WORDS_PER_SITE,
    depth: int = 1,
) -> HaloSpec:
    """The halo spec of an L^4 lattice split into ``n_shards`` t-slabs (the
    reference takes a mesh and reads its host-axis size; the port takes the
    count).

    Args:
        L: lattice extent.
        n_shards: slab count.
        word_bytes: explicit storage word width; when ``dtype`` is given too
            they must agree.
        dtype: storage dtype name; prices bf16 lattices at 2 B/word.
        words_per_site: exchanged-field payload (72 gauge, 6 vectors).
        depth: ghost-zone thickness in faces.

    Raises:
        ValueError: the lattice does not split over ``n_shards``, or
            ``word_bytes`` contradicts ``dtype``.
    """
    if L**4 % n_shards:
        raise ValueError(f"L={L} lattice does not shard over {n_shards} hosts")
    if dtype is not None:
        from_dtype = _WORD_BYTES[dtype]
        if word_bytes is not None and word_bytes != from_dtype:
            raise ValueError(
                f"word_bytes={word_bytes} contradicts dtype={dtype!r} "
                f"({from_dtype} B/word); pass one or the other"
            )
        word_bytes = from_dtype
    return HaloSpec(
        L=L,
        n_shards=n_shards,
        word_bytes=4 if word_bytes is None else word_bytes,
        words_per_site=words_per_site,
        depth=depth,
    )


# ---------------------------------------------------------------------------
# LM rules: logical axes -> mesh axes, as arithmetic over axis sizes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named axis sizes, the reference's ``jax.sharding.Mesh`` as the rules
    read it: ``axis_names`` in order, ``shape[name]`` and ``size``.  One card
    is ``LogicalMesh.of(data=1, model=1)``; larger meshes are logical (the
    dry run's analytic ``multi`` mesh)."""

    axes: tuple[tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "LogicalMesh":
        return cls(tuple(sizes.items()))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, k in self.axes:
            n *= k
        return n


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical axis name -> tuple of mesh axis names (in sharding order)."""

    data_axes: tuple[str, ...] = ("data",)  # batch / DP
    fsdp_axes: tuple[str, ...] = ("data",)  # param 'embed' dim / ZeRO
    model_axes: tuple[str, ...] = ("model",)  # TP / EP
    seq_axes: tuple[str, ...] = ()  # SP (long-context)

    def logical(self) -> dict[str, tuple[str, ...]]:
        return {
            "batch": self.data_axes,
            "embed": self.fsdp_axes,
            "vocab": self.model_axes,
            "heads": self.model_axes,
            "kv_heads": self.model_axes,
            "mlp": self.model_axes,
            "experts": self.model_axes,
            "latent": (),  # MLA latents replicated, as the reference's rules keep them
            "seq": self.seq_axes,
            "layers": (),
        }


def default_rules(mesh: LogicalMesh, *, fsdp: bool = True) -> MeshRules:
    """The reference's defaults: (data, model) meshes put DP and FSDP over
    data and TP/EP over model; (pod, data, model) meshes DP and FSDP over
    (pod, data)."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return MeshRules(data_axes=dp, fsdp_axes=dp if fsdp else (), model_axes=("model",))


def axis_size(mesh: LogicalMesh, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


Assignment = Any  # None, a mesh axis name, or a tuple of them


def resolve_spec(axes: tuple[str | None, ...], shape: tuple[int, ...], mesh: LogicalMesh,
                 rules: MeshRules) -> tuple[Assignment, ...]:
    """Logical axes + concrete shape -> the mesh axes each dim shards over
    (the reference's ``PartitionSpec`` entries, trailing ``None`` dropped):
    a dim takes its logical axis's mesh axes that no earlier dim took, if
    their size divides it, else stays whole."""
    table = rules.logical()
    used: set[str] = set()
    out: list[Assignment] = []
    for dim, name in zip(shape, axes):
        assignment: Assignment = None
        if name is not None:
            mesh_axes = tuple(a for a in table.get(name, ()) if a not in used)
            if mesh_axes and dim % axis_size(mesh, mesh_axes) == 0:
                assignment = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                used.update(mesh_axes)
        out.append(assignment)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def state_spec_for(key: str, shape: tuple[int, ...], mesh: LogicalMesh, rules: MeshRules, *,
                   kv_seq_shard: bool = False) -> tuple[Assignment, ...]:
    """A decode/prefill state leaf's mesh axes by its key's last name and its
    rank, the reference's layout contracts: KV caches (stacked (L, B, S, H,
    D) or per layer (B, S, H, D)) batch over data, kv heads over model where
    they divide (else, with ``kv_seq_shard``, the sequence); MLA latents
    (``ckv``, ``k_rope``) batch only (or the sequence); SSM ``ssm`` heads and
    ``conv`` channels over model; any other leaf of rank >= 2 batch over
    data."""
    model = rules.model_axes
    msize = axis_size(mesh, model)
    mx = model if len(model) > 1 else (model[0] if model else None)
    dsize = axis_size(mesh, rules.data_axes)

    def d_if(dim: int) -> Assignment:
        if rules.data_axes and dim % dsize == 0:
            return rules.data_axes if len(rules.data_axes) > 1 else rules.data_axes[0]
        return None

    def m_if(dim: int) -> Assignment:
        return mx if mx is not None and dim % msize == 0 else None

    name = key.split("/")[-1]
    r = len(shape)
    if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v") and r == 5:
        h_ax = m_if(shape[3])
        s_ax = m_if(shape[2]) if (kv_seq_shard and h_ax is None) else None
        return (None, d_if(shape[1]), s_ax, h_ax, None)
    if name in ("k", "v") and r == 4:
        h_ax = m_if(shape[2])
        s_ax = m_if(shape[1]) if (kv_seq_shard and h_ax is None) else None
        return (d_if(shape[0]), s_ax, h_ax, None)
    if name in ("ckv", "k_rope") and r == 4:
        return (None, d_if(shape[1]), m_if(shape[2]) if kv_seq_shard else None, None)
    if name in ("ckv", "k_rope") and r == 3:
        return (d_if(shape[0]), m_if(shape[1]) if kv_seq_shard else None, None)
    if name == "ssm" and r == 5:
        return (None, d_if(shape[1]), m_if(shape[2]), None, None)
    if name == "ssm" and r == 4:
        return (d_if(shape[0]), m_if(shape[1]), None, None)
    if name == "conv" and r == 4:
        return (None, d_if(shape[1]), None, m_if(shape[3]))
    if name == "conv" and r == 3:
        return (d_if(shape[0]), None, m_if(shape[2]))
    if r >= 2:
        return (d_if(shape[0]),) + (None,) * (r - 1)
    return ()


def local_numel(shape: tuple[int, ...], spec: tuple[Assignment, ...], mesh: LogicalMesh) -> int:
    """Elements of one device's shard of a ``shape`` laid out by ``spec``."""
    n = 1
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        div = 1
        if ax is not None:
            div = axis_size(mesh, ax if isinstance(ax, tuple) else (ax,))
        n *= dim // max(div, 1)
    return n


# ---------------------------------------------------------------------------
# LM rules as DTensor placements on a DeviceMesh
# ---------------------------------------------------------------------------


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (a leaf or an activation of a mesh run)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def whole(x: Any) -> Any:
    """``x`` detached, a DTensor gathered whole on every rank (a collective:
    every rank calls it)."""
    x = x.detach()
    return x.full_tensor() if is_dtensor(x) else x


def mesh_rank(mesh: Any, dims: list[int]) -> tuple[int, int]:
    """(this rank's index, the count) over the mesh dims ``dims`` taken as
    one axis, major first: (0, 1) over none."""
    coord, shards, r = mesh.get_coordinate(), 1, 0
    for i in dims:
        r = r * mesh.size(i) + coord[i]
        shards *= mesh.size(i)
    return r, shards


def logical_mesh(mesh: Any) -> LogicalMesh:
    """The axis sizes of ``mesh``: a :class:`LogicalMesh` as it is, or a
    ``DeviceMesh``'s ``mesh_dim_names`` and shape."""
    if isinstance(mesh, LogicalMesh):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the LM rules read mesh axes by name: build the mesh with axis names")
    return LogicalMesh(tuple(zip(names, (int(n) for n in mesh.shape))))


def placements_of(spec: tuple[Assignment, ...], mesh: Any) -> tuple[Any, ...]:
    """A :func:`resolve_spec` result as DTensor placements, one per mesh dim:
    ``Shard(i)`` on each mesh axis that dim ``i`` takes, ``Replicate()`` on
    the others.  A dim over several axes (``("pod", "data")``) takes them
    in the mesh's order, major first, as the reference's ``PartitionSpec``
    lays them out.

    Raises:
        ValueError: an axis the mesh lacks, or several axes out of the
            mesh's order (a layout one ``Shard`` per mesh dim cannot give).
    """
    from torch.distributed.tensor import Replicate, Shard

    names = logical_mesh(mesh).axis_names
    out: list[Any] = [Replicate()] * len(names)
    for dim, assignment in enumerate(spec):
        if assignment is None:
            continue
        axes = assignment if isinstance(assignment, tuple) else (assignment,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec} names an axis the mesh {names} lacks")
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} shards over {axes}, out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists (``rest`` shaped
    like ``tree``)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_placements(spec_tree: Any, mesh: Any, rules: MeshRules) -> Any:
    """ParamSpec tree -> a tree of placement tuples (params, grads and the
    AdamW moments), by :func:`resolve_spec`'s fallbacks: a dim that does
    not divide its mesh axes stays whole, and no mesh axis serves two dims
    of a leaf."""
    lm = logical_mesh(mesh)
    return _map_tree(lambda s: placements_of(resolve_spec(s.axes, s.shape, lm, rules), lm),
                     spec_tree)


def opt_state_placements(param_pl: Any, mesh: Any) -> dict[str, Any]:
    """The AdamW state's placements: each moment as its parameter, the step
    count replicated."""
    from torch.distributed.tensor import Replicate

    return {"m": param_pl, "v": param_pl,
            "count": (Replicate(),) * len(logical_mesh(mesh).axis_names)}


def batch_placements(shapes: dict[str, tuple[int, ...]], mesh: Any,
                     rules: MeshRules) -> dict[str, tuple[Any, ...]]:
    """Input batches shard their leading (batch) dim over the data axes when
    it divides them, else stay replicated."""
    lm = logical_mesh(mesh)
    dp = tuple(rules.data_axes)
    out = {}
    for name, shape in shapes.items():
        spec: tuple[Assignment, ...] = ()
        if dp and shape and shape[0] % axis_size(lm, dp) == 0:
            spec = (dp if len(dp) > 1 else dp[0],)
        out[name] = placements_of(spec, lm)
    return out


def distribute(x: Any, mesh: Any, placements: tuple[Any, ...]) -> Any:
    """A full tensor (or numpy array), the same on every rank, as a DTensor
    on ``mesh``: each rank keeps its own shard, cut locally (no collective)
    and contiguous."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    t = t.detach().to(mesh.device_type)
    d = distribute_tensor(t, mesh, list(placements), src_data_rank=None)
    local = d.to_local()
    if not local.is_contiguous() or (local.numel() < t.numel() and (
            local.untyped_storage().nbytes() > local.numel() * local.element_size())):
        # a copy of its own: a shard must not hold the whole leaf's storage
        # (a shard that is the whole leaf keeps the storage it came in)
        d = DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh,
                               list(placements), run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def distribute_batch(batch: dict[str, Any], mesh: Any, rules: MeshRules) -> dict[str, Any]:
    """A whole input batch, the same on every rank, as DTensors at
    :func:`batch_placements`: each rank keeps its rows."""
    pl = batch_placements({k: tuple(v.shape) for k, v in batch.items()}, mesh, rules)
    return {k: distribute(v, mesh, pl[k]) for k, v in batch.items()}


def distribute_tree(tree: Any, spec_tree: Any, mesh: Any, rules: MeshRules) -> Any:
    """Full leaves (tensors or numpy arrays, the same on every rank) ->
    DTensors on ``mesh`` at :func:`param_placements`; ``tree`` is shaped
    like ``spec_tree`` (the reference's tree: stacked layers)."""
    return _map_tree(lambda x, pl: distribute(x, mesh, pl), tree,
                     param_placements(spec_tree, mesh, rules))


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts and lists; a path
    names dict keys and list indices, as the reference's tree paths do."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def state_placements(state_tree: Any, mesh: Any, rules: MeshRules, *,
                     kv_seq_shard: bool = False) -> Any:
    """A decode/prefill state tree (leaves with a ``shape``: tensors, on
    ``meta`` too) -> a tree of placement tuples, the counterpart of the
    reference's ``state_shardings``: each leaf keyed by its path
    (``"dense/0/k"``) and resolved by :func:`state_spec_for`.

    The port keeps a stack's caches as a list of per-layer leaves where the
    reference stacks them over a leading layer dim; the rules read a leaf's
    last name and its rank, and give a per-layer leaf the stacked leaf's
    layout without that dim (whisper's stacked caches, as the reference's).
    """
    lm = logical_mesh(mesh)

    def one(path, leaf):
        key = "/".join(map(str, path))
        spec = state_spec_for(key, tuple(leaf.shape), lm, rules, kv_seq_shard=kv_seq_shard)
        return placements_of(spec, lm)

    return _map_with_path(one, state_tree)


def local_shape(shape: tuple[int, ...], placements: tuple[Any, ...], mesh: Any) -> tuple[int, ...]:
    """This rank's shard of a ``shape`` laid out by ``placements`` (every
    split even, as the rules only split dims their axes divide)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split over mesh "
                                 f"dim {i} of {mesh.size(i)}")
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def distribute_state(state_tree: Any, mesh: Any, rules: MeshRules, *,
                     kv_seq_shard: bool = False) -> Any:
    """A zero state on ``mesh`` at :func:`state_placements`: each leaf of
    ``state_tree`` (its shapes and dtypes, typically on ``meta``) becomes a
    DTensor whose rank allocates zeros for its own shard only; no rank
    builds a whole cache.  ``kv_seq_shard`` places the caches whose kv
    heads do not divide the model axes along their sequence; the models
    write each rank's own rows and decode by combining each rank's partial
    softmax (``models.attention.write_cache``, ``_decode_seq``)."""
    import torch
    from torch.distributed.tensor import DTensor

    pl_tree = state_placements(state_tree, mesh, rules, kv_seq_shard=kv_seq_shard)

    def one(leaf, pl):
        shape = tuple(leaf.shape)
        local = torch.zeros(local_shape(shape, pl, mesh), dtype=leaf.dtype,
                            device=mesh.device_type)
        return DTensor.from_local(local, mesh, list(pl), run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    return _map_tree(one, state_tree, pl_tree)
