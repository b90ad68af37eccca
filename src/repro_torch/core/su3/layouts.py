"""Lattice data layouts for the SU3 kernel (PyTorch port of
``repro.core.su3.layouts``).

The physical layouts, word for word as in the reference:

  * ``AOS``   — the paper's MILC ``site`` struct: (n_sites, 80) words per
                site, 72 gauge words (interleaved re, im; link-major) plus 8
                metadata/pad words.  The pads are streamed and charged.
  * ``SOA``   — planar structure-of-arrays: (2, 36, n_sites), re/im planes,
                site index innermost, so a row of one entry over consecutive
                sites is unit-stride.
  * ``AOSOA`` — site-tiled SoA: (n_tiles, 2, 36, tile); site
                ``s = tile_idx * tile + lane``.

Canonical (logical) form everywhere else is complex:
  A : (n_sites, 4, 3, 3) complex64   B : (4, 3, 3) complex64.

Every function here only moves data (and, for two-row storage, rebuilds the
third row), so pack/unpack equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

LINKS = 4  # links per site (the j loop)
SU3 = 3  # SU(3) matrix dimension
GAUGE_WORDS = LINKS * SU3 * SU3 * 2  # 72 real words of gauge field per site
SITE_PAD_WORDS = 8  # x, y, z, t, index, parity(+align), pad[2]  (PRECISION==1)
SITE_WORDS_AOS = GAUGE_WORDS + SITE_PAD_WORDS  # 80 words = 320 B fp32, paper-faithful
LANE = 128  # default AoSoA lane width / site tile

PLANAR_ROWS = LINKS * SU3 * SU3  # 36 complex entries per site
# Two-row compressed planar form: 4 links x 2 stored rows x 3 cols = 24
# complex entries per site (48 real words), in full-form row order with
# every k=2 row deleted.
PLANAR_COMP_ROWS = LINKS * 2 * SU3  # 24
GAUGE_COMP_WORDS = PLANAR_COMP_ROWS * 2  # 48 real words per site
COMP_ROW_INDICES = tuple(
    (j * SU3 + k) * SU3 + l
    for j in range(LINKS)
    for k in range(2)
    for l in range(SU3)
)

TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


class Layout(str, enum.Enum):
    AOS = "aos"
    SOA = "soa"
    AOSOA = "aosoa"


class GaugeCompression(str, enum.Enum):
    """How many rows of each SU(3) link the physical form stores.

    ``TWO_ROW`` stores rows 0 and 1 only (12 of 18 reals per link); row 2 is
    the unitarity cross product ``conj(row0 x row1)``, exact on SU(3).
    """

    NONE = "none"
    TWO_ROW = "two_row"


@dataclasses.dataclass(frozen=True)
class LatticeShape:
    """Lattice of dimension L^4, matching the paper's ``total_sites = L**4``."""

    L: int

    @property
    def n_sites(self) -> int:
        return self.L**4

    def padded_sites(self, lane: int = LANE) -> int:
        return ((self.n_sites + lane - 1) // lane) * lane


# ---------------------------------------------------------------------------
# Canonical <-> physical layout converters.
# ---------------------------------------------------------------------------


def _real_dtype(complex_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if complex_dtype == torch.complex128 else torch.float32


def to_planar(a: torch.Tensor) -> torch.Tensor:
    """complex (...) -> stacked planar (2, ...) real tensor (re, im)."""
    return torch.stack([a.real, a.imag], dim=0)


def from_planar(p: torch.Tensor) -> torch.Tensor:
    """Planar (2, ...) f32/f64 -> complex (...)."""
    return torch.complex(p[0], p[1])


def pack_aos(a: torch.Tensor, site_meta: torch.Tensor | None = None) -> torch.Tensor:
    """Canonical A (n_sites, 4, 3, 3) complex -> paper-faithful AoS (n_sites, 80).

    Words [0:72] are interleaved (re, im) gauge entries in link-major order;
    words [72:80] are the metadata block: the linear site id in the five
    coordinate/index words, its parity, and two zero pads.
    """
    n_sites = a.shape[0]
    dt = _real_dtype(a.dtype)
    gauge = torch.stack([a.real, a.imag], dim=-1)  # (s, 4, 3, 3, 2)
    gauge = gauge.reshape(n_sites, GAUGE_WORDS).to(dt)
    if site_meta is None:
        idx = torch.arange(n_sites, dtype=dt, device=a.device)[:, None]
        site_meta = torch.cat(
            [idx, idx, idx, idx, idx, idx % 2,
             torch.zeros((n_sites, 2), dtype=dt, device=a.device)],
            dim=1,
        )
    return torch.cat([gauge, site_meta.to(dt)], dim=1)


def unpack_aos(aos: torch.Tensor, complex_dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    n_sites = aos.shape[0]
    gauge = aos[:, :GAUGE_WORDS].reshape(n_sites, LINKS, SU3, SU3, 2)
    return torch.complex(gauge[..., 0], gauge[..., 1]).to(complex_dtype)


def pack_soa(a: torch.Tensor) -> torch.Tensor:
    """Canonical (n_sites, 4, 3, 3) complex -> SoA planar (2, 4, 3, 3, n_sites)."""
    return to_planar(torch.movedim(a, 0, -1))


def unpack_soa(soa: torch.Tensor, complex_dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    return torch.movedim(from_planar(soa), -1, 0).to(complex_dtype)


def _pad_sites(a: torch.Tensor, lane: int) -> torch.Tensor:
    pad = (-a.shape[0]) % lane
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)


def pack_aosoa(a: torch.Tensor, lane: int = LANE) -> torch.Tensor:
    """Canonical -> (n_tiles, 2, 4, 3, 3, lane). Pads site count up to lane."""
    a = _pad_sites(a, lane)
    n_tiles = a.shape[0] // lane
    t = torch.movedim(a.reshape(n_tiles, lane, LINKS, SU3, SU3), 1, -1)
    return torch.stack([t.real, t.imag], dim=1)


def unpack_aosoa(
    t: torch.Tensor, n_sites: int, complex_dtype: torch.dtype = torch.complex64
) -> torch.Tensor:
    c = torch.complex(t[:, 0], t[:, 1])  # (tiles, 4, 3, 3, lane)
    c = torch.movedim(c, -1, 1).reshape(-1, LINKS, SU3, SU3)
    return c[:n_sites].to(complex_dtype)


def reconstruct_third_row(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """row2 = conj(row0 x row1) — the SU(3) unitarity reconstruction.

    ``r0``/``r1`` are complex tensors with the color index last (..., 3).
    Expanded in real arithmetic with the operand grouping of the reference
    (``repro.core.su3.layouts.reconstruct_third_row``); every product and
    difference rounds on its own, so values agree with the reference to
    ~1 ulp (XLA may contract a product and a difference into one FMA).
    """
    a_r, a_i = r0.real, r0.imag
    b_r, b_i = r1.real, r1.imag

    def _comp(i: int, j: int) -> torch.Tensor:
        # conj(r0[i]*r1[j] - r0[j]*r1[i])
        xr = (a_r[..., i] * b_r[..., j] - a_i[..., i] * b_i[..., j]) - (
            a_r[..., j] * b_r[..., i] - a_i[..., j] * b_i[..., i]
        )
        xi = (a_r[..., i] * b_i[..., j] + a_i[..., i] * b_r[..., j]) - (
            a_r[..., j] * b_i[..., i] + a_i[..., j] * b_r[..., i]
        )
        return torch.complex(xr, -xi)

    return torch.stack([_comp(1, 2), _comp(2, 0), _comp(0, 1)], dim=-1)


# ---------------------------------------------------------------------------
# LayoutCodec — pack/unpack as a first-class object.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayoutCodec:
    """Canonical <-> physical converter for one (layout, tile, word dtype).

    ``tile`` is the AoSoA lane width and the plan's site padding unit; AOS
    and SOA carry it so a codec fully identifies the physical form.  It is
    not the CUDA kernel's block size, which the kernel module chooses.

    ``accum_dtype`` ("" = same as ``dtype``) is the compute width of
    mixed-precision plans: words are stored at ``dtype`` while the kernel
    accumulates at ``accum_dtype``.

    ``compression`` selects the stored-row set of each link.  TWO_ROW keeps
    rows 0 and 1 only (24 planar rows instead of 36); only ``unpack`` (the
    canonical escape hatch) rebuilds row 2, in f32, via
    :func:`reconstruct_third_row`.
    """

    layout: Layout
    tile: int = LANE
    dtype: str = "float32"
    accum_dtype: str = ""  # "" => accumulate at the storage dtype
    compression: GaugeCompression = GaugeCompression.NONE

    @property
    def word_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def is_compressed(self) -> bool:
        return self.compression == GaugeCompression.TWO_ROW

    @property
    def planar_rows(self) -> int:
        """Planar gauge rows of the physical form: 36 full, 24 two-row."""
        return PLANAR_COMP_ROWS if self.is_compressed else PLANAR_ROWS

    @property
    def stored_rows(self) -> int:
        """SU(3) matrix rows present in storage (3 full, 2 compressed)."""
        return 2 if self.is_compressed else SU3

    @property
    def compute_dtype(self) -> str:
        """The dtype the multiply chain runs at: accum_dtype when set, else
        the word dtype."""
        return self.accum_dtype or self.dtype

    @property
    def is_mixed_precision(self) -> bool:
        return bool(self.accum_dtype) and self.accum_dtype != self.dtype

    def phys_shape(self, n_sites: int) -> tuple[int, ...]:
        """Shape of the physical form of ``n_sites`` sites (AoSoA pads them
        up to the tile)."""
        if self.layout == Layout.AOS:
            return (n_sites, SITE_WORDS_AOS)
        if self.layout == Layout.SOA:
            return (2, self.planar_rows, n_sites)
        return (-(-n_sites // self.tile), 2, self.planar_rows, self.tile)

    # -- canonical <-> physical ------------------------------------------------

    def pack(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical complex (n_sites, 4, 3, 3) -> physical layout tensor.

        TWO_ROW drops each link's third row before laying out — the stored
        form is (2, 24, S) / (tiles, 2, 24, tile).
        """
        wdt = self.word_dtype
        if self.layout == Layout.AOS:
            return pack_aos(a).to(wdt)  # (S, 80)
        if self.is_compressed:
            a = a[:, :, :2, :]  # (S, 4, 2, 3): keep rows 0, 1
        rows = self.planar_rows
        if self.layout == Layout.SOA:
            return to_planar(torch.movedim(a, 0, -1)).reshape(2, rows, -1).to(wdt)
        a = _pad_sites(a, self.tile)
        n_tiles = a.shape[0] // self.tile
        t = torch.movedim(a.reshape((n_tiles, self.tile) + tuple(a.shape[1:])), 1, -1)
        p = torch.stack([t.real, t.imag], dim=1)
        return p.reshape(n_tiles, 2, rows, self.tile).to(wdt)

    def unpack(self, phys: torch.Tensor, n_sites: int | None = None) -> torch.Tensor:
        """Physical -> canonical complex64; slice to ``n_sites`` when given.

        For TWO_ROW storage the third row is reconstructed here, in f32.
        """
        f32 = phys.to(torch.float32)
        sr = self.stored_rows
        if self.layout == Layout.AOS:
            c = unpack_aos(f32)
        elif self.layout == Layout.SOA:
            c = unpack_soa(f32.reshape(2, LINKS, sr, SU3, -1))
        else:
            t = f32.reshape(phys.shape[0], 2, LINKS, sr, SU3, self.tile)
            cc = torch.complex(t[:, 0], t[:, 1])  # (tiles, 4, sr, 3, lane)
            c = torch.movedim(cc, -1, 1).reshape(-1, LINKS, sr, SU3)
        if self.is_compressed:
            r2 = reconstruct_third_row(c[:, :, 0, :], c[:, :, 1, :])
            c = torch.cat([c, r2[:, :, None, :]], dim=2)
        return c if n_sites is None else c[:n_sites]

    def pack_b(self, b: torch.Tensor) -> torch.Tensor:
        """Canonical B (4, 3, 3) complex -> planar (2, 36) in the word dtype."""
        return to_planar(b).reshape(2, PLANAR_ROWS).to(self.word_dtype)

    def unpack_b(self, b_p: torch.Tensor) -> torch.Tensor:
        return from_planar(b_p.to(torch.float32).reshape(2, LINKS, SU3, SU3))

    # -- color-vector fields (the stencil workload's v) ------------------------
    #
    # The vector field is planar (2, 3, S) in every layout: it has no AoS
    # metadata and no per-layout physical form; only the word dtype and the
    # site padding vary.  Site order is the lattice's linear site id.

    def pack_vec(self, v: torch.Tensor, padded_sites: int | None = None) -> torch.Tensor:
        """Canonical vector field (n_sites, 3) complex -> planar (2, 3, S)
        in the word dtype, zero-padded to ``padded_sites`` when given."""
        p = to_planar(torch.movedim(v, 0, -1))  # (2, 3, n_sites)
        if padded_sites is not None and padded_sites > v.shape[0]:
            p = torch.nn.functional.pad(p, (0, padded_sites - v.shape[0]))
        return p.to(self.word_dtype).contiguous()

    def unpack_vec(self, v_p: torch.Tensor, n_sites: int | None = None) -> torch.Tensor:
        """Planar (2, 3, S) -> canonical complex (n_sites, 3)."""
        c = torch.movedim(from_planar(v_p.to(torch.float32)), -1, 0)
        return c if n_sites is None else c[:n_sites]

    # -- the planar view --------------------------------------------------------

    @property
    def supports_planar_view(self) -> bool:
        return self.layout in (Layout.SOA, Layout.AOSOA)

    def planar_view(self, phys: torch.Tensor) -> torch.Tensor:
        """Physical -> flattened planar (2, rows, S) without changing dtype.

        Tile-major site order (s = tile_idx * tile + lane), the exact
        inverse of :meth:`from_planar_view`.  For AoSoA this is a copy; the
        CUDA kernel reads AoSoA in place and never needs it.
        """
        if self.layout == Layout.SOA:
            return phys
        if self.layout == Layout.AOSOA:
            return torch.movedim(phys, 0, 2).reshape(2, self.planar_rows, -1)
        raise ValueError(f"{self.layout} has no planar kernel view")

    def from_planar_view(self, c_p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Planar (2, rows, S) -> physical (contiguous), shaped like ``like``."""
        if self.layout == Layout.SOA:
            return c_p
        if self.layout == Layout.AOSOA:
            c_t = c_p.reshape(2, self.planar_rows, like.shape[0], self.tile)
            return torch.movedim(c_t, 2, 0).contiguous()
        raise ValueError(f"{self.layout} has no planar kernel view")


def make_codec(
    layout: Layout | str,
    tile: int = LANE,
    dtype: str = "float32",
    accum_dtype: str = "",
    compression: GaugeCompression | str = GaugeCompression.NONE,
) -> LayoutCodec:
    """The one construction site for layout codecs."""
    comp = GaugeCompression(compression)
    if comp != GaugeCompression.NONE and Layout(layout) == Layout.AOS:
        # The AoS layout reproduces the paper's 320 B site struct verbatim;
        # no compressed variant of it is defined.
        raise ValueError("gauge compression is only defined for SOA/AoSoA layouts")
    return LayoutCodec(
        layout=Layout(layout),
        tile=tile,
        dtype=dtype,
        accum_dtype=accum_dtype,
        compression=comp,
    )


# ---------------------------------------------------------------------------
# Traffic model — charges each layout the bytes it actually streams.
# ---------------------------------------------------------------------------


WORD_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Bytes moved per kernel invocation for a given layout/dtype.

    read(A) + write(C); B (288 B at f32) is read once per launch and is
    excluded, as in the paper's arithmetic-intensity computation.
    Mixed-precision plans are charged at storage width.
    """

    layout: Layout
    n_sites: int
    word_bytes: int  # 4 for fp32, 2 for bf16, 8 for fp64 — STORAGE width
    compression: GaugeCompression = GaugeCompression.NONE

    @classmethod
    def for_dtype(
        cls,
        layout: Layout,
        n_sites: int,
        dtype: str,
        compression: GaugeCompression | str = GaugeCompression.NONE,
    ) -> "TrafficModel":
        return cls(layout, n_sites, WORD_BYTES[dtype], GaugeCompression(compression))

    @property
    def words_per_site(self) -> int:
        if self.layout == Layout.AOS:
            return SITE_WORDS_AOS  # 80: pads are streamed too
        if self.compression == GaugeCompression.TWO_ROW:
            return GAUGE_COMP_WORDS  # 48: two stored rows per link
        return GAUGE_WORDS  # 72: SoA/AoSoA carry no metadata

    @property
    def bytes_per_site_rw(self) -> int:
        return 2 * self.words_per_site * self.word_bytes  # read A + write C

    @property
    def total_bytes(self) -> int:
        return self.n_sites * self.bytes_per_site_rw

    @property
    def flops_per_site(self) -> int:
        # 4 links x (3x3x3 complex MACs) x (4 mul + 4 add) = 864 (paper §3.1)
        return LINKS * SU3 * SU3 * SU3 * 8

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_site / self.bytes_per_site_rw


def paper_arithmetic_intensity(word_bytes: int = 4) -> float:
    """AI = 864 / (320 * 2) = 1.35 fp32 / 0.675 fp64 — paper §3.1 exactly."""
    return TrafficModel(Layout.AOS, 1, word_bytes).arithmetic_intensity
