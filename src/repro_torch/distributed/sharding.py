"""Halo and boundary geometry of a sharded SU3 lattice (port of the lattice
half of ``repro.distributed.sharding``).

Pure arithmetic: the L^4 lattice splits along its outermost (t) dimension
into ``n_shards`` contiguous slabs, and a nearest-neighbour stencil needs
the +-t faces of each slab from its neighbours.  The stencil's neighbour
tables (``plan.stencil_neighbor_tables``) read the boundary ranges from
here, and ``ExecutionPlan.stencil_halo`` prices the vector-field exchange.

Where the reference shards arrays with ``NamedSharding`` over a
``jax.sharding.Mesh``, the port keeps every slab in one tensor on one card:
a :class:`repro_torch.launch.mesh.SlabMesh` names the slab count, and
:func:`host_site_ranges` gives each slab's contiguous site range, which the
plan's first-touch init and its multi-slab schedules index directly.  The
reference's ``lattice_site_spec`` (a ``PartitionSpec``) has no counterpart:
nothing here partitions a tensor.
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
