"""ExecutionPlan: the one dispatch path for SU3 work (port of
``repro.core.su3.plan``: the multiply, the stencil and the CG solver, on one
slab or on a lattice split into host slabs).

    EngineConfig (L, dtype, layout, variant, tile, placement)
          │  build_plan(cfg, device | MeshSpec | SlabMesh) — single construction site
          ▼
    ExecutionPlan
      codec         LayoutCodec   pack / unpack / physical shapes
      kernel        KernelEntry   unified registry (torch variants + CUDA kernels)
      step          (a_phys, b_planar) -> c_phys, one launch, fresh output
      fused(k)      one launch chaining k multiplies
      fused_batched_step(slots, max_k)
                    one megakernel launch over a slot table, per-slot depths
      stencil_step  serial: gather the 8 neighbours (index_select), one
                    stencil launch; overlapped: exchange / interior / boundary
      cg_solve      CG on sigma I + S: per iteration one fused stencil+axpy
                    pass (two gathers, one launch; split like the stencil on
                    several slabs) and the shared epilogue

The plan's tensors live on one device per process, ``"cuda"`` unless the
caller asks for ``"cpu"``.  Placement:

  * ``sharded``      — the lattice is built directly on the device; on
                       several slabs each slab is built from numpy and
                       copied straight into its range (first touch);
  * ``host_scatter`` — built on the CPU, then copied with ``.to(device)``
                       (on ranks: rank 0 builds it and scatters the
                       slabs); the copy is timed as ``scatter_s``;
  * ``replicated``   — the whole lattice on the device (on ranks: on every
                       rank's device); ``describe`` says so on one device.

The stencil's neighbour gather runs outside the kernel, as in the
reference: ``torch.index_select`` fills a preallocated direction-major
(8, 2, 3, S) block per vector field.  CG keeps every scalar on the device
(beta and sigma travel in a (1, 2) tensor) and fetches one residual per
iteration, one iteration late.

Slabs
-----
Given a :class:`~repro_torch.launch.mesh.MeshSpec` (or the
:class:`~repro_torch.launch.mesh.SlabMesh` it resolves to), the lattice
splits along t into ``hosts`` contiguous slabs; sites are t-major, so slab
``h`` is ``host_site_ranges(...)[h]``.  The lattice pads to a whole number
of tiles per (simulated) device, as in the reference, so every slab's range
is whole tiles; the stencil's slabs are the live L^4 sites split evenly,
with the padding after the last.  Where the reference shards with
``NamedSharding``, the port indexes the slab ranges and the boundary sets
directly.

Without a process group every slab lives in one tensor on the one device.
On a ranked mesh (a process group: NCCL on the cards, gloo on the CPU) rank
``r`` of ``world`` owns ``hosts // world`` contiguous slabs and every
tensor of the plan holds only its sites (``site_range``, ``local_sites``);
the other ranks' sites arrive by point-to-point messages.  On several
slabs:

  * ``sharded`` init builds each of the process's slabs host-locally
    (numpy) and copies it into its range of the device tensor; no process
    builds the whole lattice;
  * ``stencil_step(overlap=True)`` (the default there) runs the
    reference's split schedule: the +-t ghost faces of every slab are
    gathered into their own buffers on a side CUDA stream, and the faces
    that another rank owns are sent and received there with one
    ``batch_isend_irecv`` (the exchange); the interior pass runs over
    every site through the slab-local table on the main stream meanwhile;
    the boundary pass waits on the exchange, recomputes the 2 L^3 boundary
    sites of each slab from the true ghosts and writes them over the
    interior output.  Same kernel, same per-site inputs: the serial step's
    bits.  ``depth=2`` is the communication-avoiding ring: one exchange
    (the ring's vector sites and, from other ranks, its links) feeds two
    applications;
  * ``stencil_step(overlap=False)`` on ranks exchanges the same faces
    first, then gathers the periodic neighbours from the field and the
    received faces: one kernel pass, the same bits;
  * ``cg_solve(fused=True, overlap=True)`` splits the fused pass the same
    way (ghosts of r and p; only S(p') is scattered); on ranks each
    reduction is the ranks' partial sums, gathered and added in rank
    order.

On the CPU the same schedules run in program order, with no side stream,
and give the same bits.  ``plan.tracer`` (spans per phase) and
``plan.faults`` (the ``halo`` seam after each exchange) are off by default;
each costs one ``if ...enabled`` branch.

Whole-lattice batches
---------------------
:class:`BatchedLatticeRunner` serves B independent lattices through one
plan, and ``fused_batched_step`` advances a megakernel slot table.  Both
split the batch as the reference shards its leading batch axis
(``lattice_batch_sharding``): whole lattices per mesh position, host-major
(:meth:`ExecutionPlan.lattice_batch_blocks`), one kernel launch per block
on the block's device (the kernel's batch axis stands in for the
reference's ``vmap``).  Blocks that share a device live in one tensor, and
each block's launch reads and writes its rows in place; blocks on several
devices come as a list of tensors, one per device.  On a ranked mesh a rank
holds and computes only its own blocks.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.chaos.faults import NULL_FAULT_PLAN, corrupt_ghosts
from repro_torch.core.su3 import layouts, registry
from repro_torch.core.su3 import variants as _variants  # noqa: F401  (registers torch variants)
from repro_torch.core.su3.layouts import Layout, LatticeShape, LayoutCodec
from repro_torch.distributed import sharding as dist_sharding
from repro_torch.kernels import ops as _kops  # noqa: F401  (registers the CUDA kernels)
from repro_torch.kernels.su3_stencil import STENCIL_FLOPS_PER_SITE
from repro_torch.launch.mesh import MeshSpec, SlabMesh
from repro_torch.obs.tracer import NULL_TRACER

PLACEMENTS = ("sharded", "host_scatter", "replicated")

Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def verify_tolerance(
    dtype: str, accum_dtype: str = "", reconstruct: bool = False
) -> float:
    """THE verification tolerance for a plan's checks.

    Storage rounding dominates: any plan storing bf16 words verifies at
    1e-2, even when it accumulates at f32; f32 storage verifies at 1e-5,
    two-row plans included.
    """
    del accum_dtype, reconstruct  # keyed for the future; today storage decides
    return 1e-2 if dtype == "bfloat16" else 1e-5


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The tunable tuple. One instance == one ExecutionPlan identity."""

    L: int = 16
    dtype: str = "float32"  # real STORAGE word dtype: float32 | bfloat16
    layout: Layout = Layout.SOA
    variant: str = "cuda"  # any name in registry.kernel_names() or REFERENCE_NAMES
    tile: int = 512  # site padding unit / AoSoA lane (not the CUDA block size)
    placement: str = "sharded"  # sharded | host_scatter | replicated
    iterations: int = 10
    warmups: int = 2
    accum_dtype: str = ""  # "" = accumulate at dtype; "float32" = bf16-storage plans
    compression: str = "none"  # gauge storage: "none" (18-real) | "two_row" (12-real)

    @property
    def word_bytes(self) -> int:
        return layouts.WORD_BYTES[self.dtype]

    @property
    def is_compressed(self) -> bool:
        return self.compression == layouts.GaugeCompression.TWO_ROW.value

    @property
    def compute_dtype(self) -> str:
        """The dtype the multiply chain runs at (storage dtype unless overridden)."""
        return self.accum_dtype or self.dtype

    @property
    def is_mixed_precision(self) -> bool:
        return bool(self.accum_dtype) and self.accum_dtype != self.dtype

    @property
    def complex_dtype(self) -> torch.dtype:
        return torch.complex64

    @property
    def shape(self) -> LatticeShape:
        return LatticeShape(self.L)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the CUDA device, which must exist; anything else is
    taken as given.

    Raises:
        RuntimeError: ``device`` is None and CUDA is not available.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def cli_device(name: str) -> torch.device:
    """The device a command line's ``--device`` names: ``"cuda"`` is the
    card, which must exist (as ``resolve_device(None)``); any other name is
    taken as given.

    Raises:
        RuntimeError: ``name`` is ``"cuda"`` and CUDA is not available.
    """
    return resolve_device(None if name == "cuda" else name)


def init_canonical(
    n_sites: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """su3_bench's make_lattice/init_link: A entries (1,0), B entries (1/3,0)."""
    shape = (n_sites, layouts.LINKS, layouts.SU3, layouts.SU3)
    a = torch.full(shape, 1.0 + 0.0j, dtype=torch.complex64, device=device)
    b = torch.full(
        (layouts.LINKS, layouts.SU3, layouts.SU3), (1.0 / 3.0) + 0.0j,
        dtype=torch.complex64, device=device,
    )
    return a, b


def resolve_mesh(mesh: MeshSpec | SlabMesh | torch.device | str | None) -> SlabMesh:
    """A plan's mesh argument as a :class:`SlabMesh`: a ``MeshSpec`` is
    resolved on the CUDA device, a ``SlabMesh`` is taken as it is, and a
    bare device (or ``None``, the CUDA device) is one slab."""
    if isinstance(mesh, SlabMesh):
        return mesh
    if isinstance(mesh, MeshSpec):
        return mesh.resolve()
    return SlabMesh(1, 1, resolve_device(mesh))


# -- per-slab first-touch init ---------------------------------------------------
#
# The canonical benchmark lattice is uniform, so a slab's physical words can
# be built host-locally without the global array: each slab is made in numpy
# and copied straight into its range of the device tensor.  Only AOS carries
# position-dependent words (the metadata block), offset to global site ids,
# so the result equals the one-slab initializer bit for bit.

_SITE_DIM = {Layout.AOS: 0, Layout.SOA: 2, Layout.AOSOA: 0}  # physical site axis


def _uniform_phys_shard(codec: LayoutCodec, n_sites: int, site_offset: int) -> np.ndarray:
    """The packed physical form of ``n_sites`` canonical A=(1,0) sites, in
    float32 words (the copy narrows them to the storage dtype, as ``pack``
    does).  ``site_offset`` is the slab's first global site id."""
    if codec.layout == Layout.AOS:
        out = np.zeros((n_sites, layouts.SITE_WORDS_AOS), np.float32)
        out[:, 0:layouts.GAUGE_WORDS:2] = 1.0  # re words; im words stay 0
        idx = np.arange(site_offset, site_offset + n_sites, dtype=np.float32)
        for col in range(5):  # x, y, z, t, index: pack_aos carries the id in all
            out[:, layouts.GAUGE_WORDS + col] = idx
        out[:, layouts.GAUGE_WORDS + 5] = idx % 2  # parity
        return out
    if codec.layout == Layout.SOA:
        # planar_rows: 36, or 24 two-row; every stored row of the uniform
        # lattice is (1, 0)
        out = np.zeros((2, codec.planar_rows, n_sites), np.float32)
        out[0] = 1.0
        return out
    out = np.zeros((n_sites // codec.tile, 2, codec.planar_rows, codec.tile), np.float32)
    out[:, 0] = 1.0
    return out


def first_touch_init(
    codec: LayoutCodec, padded_sites: int, ranges: list[tuple[int, int]],
    device: torch.device, base: int = 0,
) -> torch.Tensor:
    """The canonical lattice, built slab by slab: each of ``ranges`` is
    made host-locally and copied into its range of one device tensor; no
    global host array is built.

    Args:
        codec: the plan's layout codec (decides the physical form).
        padded_sites: the tensor's site count (whole tiles).
        ranges: the slabs' global ``[lo, hi)`` site ranges (whole tiles
            each), inside ``[base, base + padded_sites)``.
        device: where the lattice lives.
        base: the tensor's first global site id (a rank's ``site_range``
            start; 0 for the whole lattice).

    Returns:
        The physical A of sites ``[base, base + padded_sites)``, equal to
        that range of ``codec.pack(init_canonical(...))``.
    """
    phys = torch.empty(codec.phys_shape(padded_sites), dtype=codec.word_dtype, device=device)
    dim = _SITE_DIM[codec.layout]
    per_index = codec.tile if codec.layout == Layout.AOSOA else 1
    for lo, hi in ranges:
        shard = torch.from_numpy(_uniform_phys_shard(codec, hi - lo, lo))
        phys.narrow(dim, (lo - base) // per_index, (hi - lo) // per_index).copy_(shard)
    return phys


def make_raw_step(
    codec: LayoutCodec,
    kernel: registry.KernelEntry,
    *,
    tile: int,
    k_iters: int = 1,
    alias: bool = False,
) -> Step:
    """Physical step (a_phys, b_planar) -> c_phys for any kernel form.

    The one place the kernel-form dispatch happens.  Planar kernels get the
    physical SoA/AoSoA tensor as it is; canonical kernels are wrapped with
    the codec's unpack/pack and accumulate in float32 by construction.
    ``alias`` lets a planar kernel write C into A's storage; a step called
    with ``out=`` writes C there.
    """
    if not kernel.supports_layout(codec.layout):
        raise ValueError(
            f"kernel {kernel.name!r} does not support layout {codec.layout.value!r} "
            f"(supported: {[l.value for l in kernel.layouts]})"
        )
    if kernel.form == registry.BATCHED:
        raise ValueError(
            f"kernel {kernel.name!r} is slot-batched; it dispatches through "
            f"ExecutionPlan.fused_batched_step, not a single-lattice step"
        )
    if kernel.form == registry.STENCIL:
        raise ValueError(
            f"kernel {kernel.name!r} is a nearest-neighbor stencil; it "
            f"dispatches through ExecutionPlan.stencil_step, not a multiply step"
        )
    if kernel.form == registry.STENCIL_AXPY:
        raise ValueError(
            f"kernel {kernel.name!r} is a fused CG iteration body; it "
            f"dispatches through ExecutionPlan.cg_solve, not a multiply step"
        )
    if k_iters > 1 and kernel.form == registry.PLANAR and not kernel.supports_fused:
        raise ValueError(f"kernel {kernel.name!r} does not support fused iteration")
    if codec.is_mixed_precision and not kernel.supports_accum_dtype():
        raise ValueError(
            f"kernel {kernel.name!r} cannot accumulate at {codec.accum_dtype!r} "
            f"over {codec.dtype!r} storage (no accum_dtype support)"
        )
    if codec.is_compressed and not kernel.supports_compression():
        raise ValueError(
            f"kernel {kernel.name!r} cannot stream two-row compressed gauge "
            f"(no reconstruct-on-load path)"
        )

    if kernel.form == registry.PLANAR:
        if not codec.supports_planar_view:
            raise ValueError(
                f"planar kernel {kernel.name!r} needs a planar-view layout, "
                f"got {codec.layout.value!r}"
            )
        kw: dict[str, Any] = {"tile": tile, "k_iters": k_iters, "alias": alias}
        if codec.is_mixed_precision:
            kw["accum_dtype"] = codec.accum_dtype
        if codec.is_compressed:
            kw["compressed"] = True

        def raw_step(a_phys: torch.Tensor, b_p: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
            return kernel.fn(a_phys, b_p, out=out, **kw)

    else:  # canonical complex kernel wrapped by the codec

        def raw_step(a_phys: torch.Tensor, b_p: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
            b = codec.unpack_b(b_p)
            phys = a_phys
            for _ in range(k_iters):
                phys = codec.pack(kernel.fn(codec.unpack(phys), b)).contiguous()
            return phys if out is None else out.copy_(phys)

    return raw_step


def make_raw_batched_step(
    codec: LayoutCodec,
    kernel: registry.KernelEntry,
    *,
    tile: int,
    max_k: int,
    alias: bool = False,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Slot-batched step ``(a_batch, b_batch, slot_k) -> c_batch``.

    The megakernel analogue of :func:`make_raw_step`: the physical slot
    table ``a_batch (slots, ...)`` advances by ``slot_k`` chained
    multiplies per slot in ONE kernel launch.  The CUDA kernel reads SoA and
    AoSoA tables in place, so no planar view is formed.
    """
    if kernel.form != registry.BATCHED:
        raise ValueError(
            f"kernel {kernel.name!r} has form {kernel.form!r}; the batched "
            f"step needs a {registry.BATCHED!r}-form kernel"
        )
    if not kernel.supports_layout(codec.layout):
        raise ValueError(
            f"kernel {kernel.name!r} does not support layout {codec.layout.value!r} "
            f"(supported: {[l.value for l in kernel.layouts]})"
        )
    if not codec.supports_planar_view:
        raise ValueError(
            f"batched kernel {kernel.name!r} needs a planar-view layout, "
            f"got {codec.layout.value!r}"
        )
    if codec.is_mixed_precision and not kernel.supports_accum_dtype():
        raise ValueError(
            f"kernel {kernel.name!r} cannot accumulate at {codec.accum_dtype!r} "
            f"over {codec.dtype!r} storage (no accum_dtype support)"
        )
    if codec.is_compressed and not kernel.supports_compression():
        raise ValueError(
            f"kernel {kernel.name!r} cannot stream two-row compressed gauge "
            f"(no reconstruct-on-load path)"
        )
    kw: dict[str, Any] = {"tile": tile, "max_k": max_k, "alias": alias}
    if codec.is_mixed_precision:
        kw["accum_dtype"] = codec.accum_dtype
    if codec.is_compressed:
        kw["compressed"] = True

    def raw_batched(
        a_batch: torch.Tensor, b_batch: torch.Tensor, slot_k: torch.Tensor,
        out: torch.Tensor | None = None,
    ) -> torch.Tensor:
        return kernel.fn(a_batch, b_batch, slot_k, out=out, **kw)

    return raw_batched


MEGAKERNEL_VARIANT = "cuda_megakernel"  # the reference's "pallas_megakernel"
STENCIL_VARIANT = "cuda_stencil"  # the reference's "pallas_stencil"
CG_VARIANT = "cuda_cg"  # the reference's "pallas_cg"

# Default SPD shift of the CG operator A = CG_SHIFT I + S.  Each of the 8
# stencil terms applies one unitary SU(3) row, so ||S|| <= 8; sigma = 16
# keeps the symmetric part positive definite with condition number <= 3.
# The site-local-adjoint stencil is Hermitian exactly when every U_mu is
# constant along its own direction mu; on general fields CG is best-effort.
CG_SHIFT = 16.0


# -- stencil neighbour geometry -------------------------------------------------
#
# Site linearization is t-major: site = ((t*L + z)*L + y)*L + x, so slabs of
# the lattice are contiguous t-slices and the +-t neighbour of site s is
# (s +- L^3) mod L^4 — the only directions whose access crosses slabs.


def stencil_neighbor_tables(
    L: int, padded_sites: int, n_shards: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Neighbour index tables for the 8-direction stencil.

    Returns ``(global_idx, local_idx, boundary_idx)``, int32:

    * ``global_idx (8, padded_sites)`` — exact periodic neighbours, in the
      direction order (+x, +y, +z, +t, -x, -y, -z, -t).  Padding sites
      (>= L^4) point at themselves.
    * ``local_idx (8, padded_sites)`` — the same, except that +-t wrap
      within each of the ``n_shards`` contiguous slabs; it equals
      ``global_idx`` on every interior site.
    * ``boundary_idx (B,)`` — every shard's ``HaloSpec.boundary_ranges``,
      concatenated (empty on one shard).

    Raises:
        ValueError: the lattice does not split into ``n_shards`` slabs.
    """
    S = L**4
    if n_shards > 1 and S % n_shards:
        raise ValueError(f"L={L} lattice does not shard over {n_shards} slabs")
    idx = np.arange(S, dtype=np.int64)
    glob = np.tile(np.arange(padded_sites, dtype=np.int64), (8, 1))
    for d in range(4):
        stride = L**d
        c = (idx // stride) % L
        glob[d, :S] = idx + (((c + 1) % L) - c) * stride
        glob[4 + d, :S] = idx + (((c - 1) % L) - c) * stride
    local = glob.copy()
    face = L**3
    if n_shards > 1:
        per = S // n_shards
        base = (idx // per) * per
        off = idx - base
        local[3, :S] = base + (off + face) % per
        local[7, :S] = base + (off - face) % per
    spec = dist_sharding.HaloSpec(L=L, n_shards=n_shards)
    ranges = [
        np.arange(a, b, dtype=np.int64)
        for s in range(n_shards)
        for (a, b) in spec.boundary_ranges(s)
    ]
    bidx = np.concatenate(ranges) if ranges else np.empty(0, np.int64)
    return glob.astype(np.int32), local.astype(np.int32), bidx.astype(np.int32)


def init_stencil_canonical(
    n_sites: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical stencil benchmark data: U entries (1, 0), v entries (1/24, 0).

    Every output component of the 8-direction stencil is then exactly
    (1, 0) — the fixed point ``ExecutionPlan.verify_stencil`` checks.
    """
    a, _ = init_canonical(n_sites, device)
    v = torch.full((n_sites, layouts.SU3), (1.0 / 24.0) + 0.0j, dtype=torch.complex64,
                   device=device)
    return a, v


# divergence guard: rs blowing past this multiple of ||b||^2 is treated as
# breakdown (relative residual > 1e4), not slow convergence
CG_DIVERGENCE_FACTOR = 1e8


class CGError(RuntimeError):
    """Base of every structured ``cg_solve`` failure.

    ``result`` (when not None) carries the best iterate reached as a partial
    :class:`CGResult` (``converged=False``): resume with
    ``cg_solve(..., x0_p=err.result.x_p)`` instead of restarting from zero.
    """

    def __init__(self, message: str, iterations: int, residual: float,
                 tol: float, result: "CGResult | None" = None):
        super().__init__(message)
        self.iterations = iterations
        self.residual = residual
        self.tol = tol
        self.result = result


class CGMaxItersError(CGError):
    """``cg_solve`` exhausted ``max_iters`` without reaching tolerance."""

    def __init__(self, iterations: int, residual: float, tol: float,
                 result: "CGResult | None" = None):
        super().__init__(
            f"CG did not converge: relative residual {residual:.3e} > tol "
            f"{tol:.1e} after {iterations} iterations",
            iterations, residual, tol, result,
        )


class CGDivergedError(CGError):
    """``cg_solve`` hit numerical breakdown: a NaN/Inf residual or a residual
    exploding past :data:`CG_DIVERGENCE_FACTOR` x ``||b||^2``."""

    def __init__(self, iterations: int, residual: float, tol: float,
                 result: "CGResult | None" = None, reason: str = "diverged"):
        super().__init__(
            f"CG {reason}: relative residual {residual:.3e} (tol {tol:.1e}) "
            f"after {iterations} iterations",
            iterations, residual, tol, result,
        )
        self.reason = reason


@dataclasses.dataclass
class CGResult:
    """One CG solve: the planar solution plus its residual history.

    ``residuals[i]`` is the relative residual ``||r|| / ||b||`` after
    iteration ``i + 1``.
    """

    x_p: torch.Tensor
    iterations: int
    residuals: list[float]
    converged: bool
    wall_s: float


def stencil_apply_reference(u: torch.Tensor, v: torch.Tensor, L: int) -> torch.Tensor:
    """Plain-torch 8-direction stencil on canonical complex tensors: the
    oracle CG convergence is pinned against (not on the path).

    ``u (S, 4, 3, 3)`` complex links, ``v (S, 3)`` complex vector field.
    """
    S = L**4
    glob, _local, _b = stencil_neighbor_tables(L, S, 1)
    g = torch.from_numpy(glob.astype(np.int64)).to(v.device)
    out = torch.zeros_like(v)
    for mu in range(layouts.LINKS):
        out = out + torch.einsum("skl,sl->sk", u[:, mu], v[g[mu]])
        out = out + torch.einsum("slk,sl->sk", torch.conj(u[:, mu]), v[g[4 + mu]])
    return out


def cg_reference_solve(
    u: torch.Tensor,
    b: torch.Tensor,
    L: int,
    *,
    tol: float = 1e-6,
    max_iters: int = 200,
    sigma: float = CG_SHIFT,
) -> tuple[torch.Tensor, list[float], bool]:
    """Plain-torch CG on ``A = sigma I + S``: the convergence oracle for
    :meth:`ExecutionPlan.cg_solve` (not on the path).

    Textbook complex CG on canonical tensors; returns ``(x, relative
    residuals per iteration, converged)`` and never raises on exhaustion.
    """

    def apply(p: torch.Tensor) -> torch.Tensor:
        return sigma * p + stencil_apply_reference(u, p, L)

    def norm2(v: torch.Tensor) -> torch.Tensor:
        return torch.sum(v.real**2 + v.imag**2)

    b_rs = float(norm2(b))
    if b_rs == 0.0:
        return torch.zeros_like(b), [], True
    x, r, p = torch.zeros_like(b), b, b
    rs = norm2(r)
    residuals: list[float] = []
    for _ in range(max_iters):
        ap = apply(p)
        pap = torch.real(torch.vdot(p.flatten(), ap.flatten()))
        alpha = rs / pap
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = norm2(r)
        residuals.append(float(rs_new / b_rs) ** 0.5)
        if residuals[-1] <= tol:
            return x, residuals, True
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, residuals, False


def _fetch_later(t: torch.Tensor) -> Callable[[], float]:
    """Start copying a device scalar to the host; the returned call waits for
    that copy only (not for work issued after it) and gives the value."""
    if t.device.type != "cuda":
        return lambda: float(t)
    buf = torch.empty((), dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def get() -> float:
        done.synchronize()
        return float(buf)

    return get


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_to_tile(idx: torch.Tensor, tile: int) -> torch.Tensor:
    """Site indices (last axis) padded to a whole number of tiles by
    repeating the first: the kernels need whole tiles, a site's bits depend
    on its own inputs only, and the padding's outputs are dropped."""
    pad = (-idx.shape[-1]) % tile
    return torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], pad)], dim=-1)


def _pad_ids(ids: np.ndarray, tile: int) -> np.ndarray:
    """:func:`_pad_to_tile` on a numpy list of site ids."""
    return np.concatenate([ids, np.repeat(ids[:1], (-ids.size) % tile)])


def _select(field: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return field.index_select(-1, idx)


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """``t`` lies on ``dev``: the same card (a CUDA device with no index is
    the current one), or the CPU, whatever index names it (a list of
    ``cpu:i`` devices stands for distinct devices on one CPU)."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    return t.device.index == (torch.cuda.current_device() if dev.index is None else dev.index)


def _as_parts(x: torch.Tensor | list[torch.Tensor]) -> list[torch.Tensor]:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _launch_blocks(
    blocks: list[dist_sharding.BatchBlock], fn: Callable[..., torch.Tensor], alias: bool,
    a: torch.Tensor | list[torch.Tensor], *operands: torch.Tensor | list[torch.Tensor],
) -> torch.Tensor | list[torch.Tensor]:
    """One launch of ``fn`` per block of a whole-lattice batch, on the
    block's device.

    ``a`` and every operand hold the blocks' lattices along their first
    axis: one tensor when the blocks share one device, else a list with one
    tensor per run of blocks on a device
    (:func:`~repro_torch.distributed.sharding.device_parts`).  ``fn(a_blk,
    *operand_blks, out=out_blk)`` runs on each block's rows: into the same
    rows of a new tensor, or in place into ``a`` when ``alias`` (then
    ``out`` is None).  Returns the output in ``a``'s form.

    Raises:
        ValueError: a tensor does not hold its device's blocks (wrong
            count, size or device), e.g. one tensor for blocks on several
            devices.
    """
    parts = dist_sharding.device_parts(blocks)
    a_parts, op_parts = _as_parts(a), [_as_parts(x) for x in operands]
    if len(a_parts) != len(parts) or any(len(x) != len(parts) for x in op_parts):
        raise ValueError(f"the batch's blocks lie on {len(parts)} device run(s): pass one "
                         f"tensor per run, got {len(a_parts)}")
    outs = []
    for j, part in enumerate(parts):
        base, n_rows, dev = part[0].lo, part[-1].hi - part[0].lo, part[0].device
        x = a_parts[j]
        if x.shape[0] != n_rows or not _on(x, dev):
            raise ValueError(f"blocks {[blk.index for blk in part]} hold {n_rows} lattices on "
                             f"{dev}, got {x.shape[0]} on {x.device}")
        out = x if alias else torch.empty_like(x)
        for blk in part:
            lo, n = blk.lo - base, blk.hi - blk.lo
            fn(x.narrow(0, lo, n), *(ops[j].narrow(0, lo, n) for ops in op_parts),
               out=None if alias else out.narrow(0, lo, n))
        outs.append(out)
    return outs[0] if isinstance(a, torch.Tensor) else outs


class _Halo:
    """One pattern of exchange between the ranks of a slab mesh.

    ``needs[q]`` is the sorted global site ids rank ``q`` reads and does not
    own.  Every rank builds the same lists, so each knows what it receives
    from each peer and which of its own sites each peer receives.  ``peers``
    are the ranks this rank sends to or receives from, ascending; the sites
    it receives are ``needs[rank]`` in that order, one buffer per peer.
    Without a group (one rank) nothing crosses.
    """

    def __init__(self, needs: list[np.ndarray], ranges: list[tuple[int, int]], rank: int,
                 device: torch.device, global_rank: Callable[[int], int]):
        self.lo, self.hi = ranges[rank]
        self.needed = needs[rank]
        self.peers: list[tuple[int, torch.Tensor, int]] = []  # (global rank, send idx, n_recv)
        for q, (qlo, qhi) in enumerate(ranges):
            if q == rank:
                continue
            n_recv = int(np.count_nonzero((self.needed >= qlo) & (self.needed < qhi)))
            theirs = needs[q]
            send = theirs[(theirs >= self.lo) & (theirs < self.hi)] - self.lo
            if n_recv or send.size:
                self.peers.append((global_rank(q), torch.from_numpy(send).to(device), n_recv))
        counts = np.array([n for _, _, n in self.peers], np.int64)
        self._ends = np.cumsum(counts)
        self._starts = self._ends - counts

    @property
    def crosses(self) -> bool:
        return bool(self.peers)

    def locate(self, gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(source, index)`` of each global site id: source 0 is this
        rank's field (index ``gid - lo``), source ``1 + j`` the receive
        buffer of the ``j``-th peer."""
        gids = np.asarray(gids, np.int64)
        src = np.zeros(gids.shape, np.int64)
        idx = gids - self.lo
        remote = (gids < self.lo) | (gids >= self.hi)
        if remote.any():
            pos = np.searchsorted(self.needed, gids[remote])
            if (pos >= self.needed.size).any() or not np.array_equal(self.needed[pos],
                                                                     gids[remote]):
                raise AssertionError("a remote site outside the exchange's needs")
            j = np.searchsorted(self._ends, pos, side="right")
            src[remote] = 1 + j
            idx[remote] = pos - self._starts[j]
        return src, idx


# one field of an exchange: (halo, field, select(field, idx), buffer slot, rows)
_PostEntry = tuple[_Halo, torch.Tensor, Callable[..., torch.Tensor], str, int]


class _Gather:
    """``out[..., i]`` from site ``idx[i]`` of source ``src[i]`` (a
    :meth:`_Halo.locate`): source 0 is this rank's field, gathered by
    :meth:`local`; the rest are receive buffers, gathered by :meth:`remote`
    once they arrive.  A source that fills all of ``out`` is one
    ``index_select`` into it."""

    def __init__(self, src: np.ndarray, idx: np.ndarray, device: torch.device):
        self.parts: list[tuple[int, torch.Tensor, torch.Tensor | None]] = []
        for s in np.unique(src):
            m = src == s
            pos = None if m.all() else torch.from_numpy(np.nonzero(m)[0]).to(device)
            self.parts.append((int(s), torch.from_numpy(idx[m]).to(device), pos))

    @property
    def all_local(self) -> bool:
        return all(s == 0 for s, _, _ in self.parts)

    def local(self, field: torch.Tensor, out: torch.Tensor,
              select: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _select) -> None:
        for s, idx, pos in self.parts:
            if s:
                continue
            if pos is None and select is _select:
                torch.index_select(field, -1, idx, out=out)
            elif pos is None:
                out.copy_(select(field, idx))
            else:
                out.index_copy_(-1, pos, select(field, idx))

    def remote(self, recv: list[torch.Tensor], out: torch.Tensor) -> None:
        for s, idx, pos in self.parts:
            if not s:
                continue
            if pos is None:
                torch.index_select(recv[s - 1], -1, idx, out=out)
            else:
                out.index_copy_(-1, pos, recv[s - 1].index_select(-1, idx))


class ExecutionPlan:
    """Execution of one EngineConfig tuple on one slab mesh.

    Construct via :func:`build_plan` — the single construction site for every
    layout x variant x placement combination.

    Attributes:
        codec: canonical (S, 4, 3, 3) complex <-> physical layout conversions.
        kernel: the resolved :class:`~repro_torch.core.su3.registry.KernelEntry`.
        mesh: the :class:`~repro_torch.launch.mesh.SlabMesh` (slab count,
            devices per slab, the device; on ranks the rank and the group).
        device: the plan's device (this process's slabs live there).
        n_devices: hosts x devices per host (simulated devices share the
            card); the padding unit is ``n_devices * tile`` sites.
        site_axes: the mesh axes the sites run over, host-major.
        is_multi_host: the lattice splits into more than one slab.
        is_ranked: the slabs are spread over a process group's ranks.
        rank, world: this process's rank and the group's size (0 and 1
            without a group).
        padded_sites: site count padded so every device's share is whole tiles.
        site_range: the global ``[lo, hi)`` sites this process holds
            (``(0, padded_sites)`` without a group).
        local_sites: ``hi - lo``: the site count of every field tensor the
            plan takes and returns (``pack_gauge``, ``pack_rhs``, the
            stencil and CG fields, ``init_data``'s A under ``sharded``).
        step: ``(a_phys, b_planar) -> c_phys`` — one launch into a fresh
            output; the input is left intact (``SU3Engine.run`` reuses it).
        tracer: phase spans of the stencil and CG schedules; off
            (``NULL_TRACER``) by default.  When on, each phase synchronizes
            the device at its end so its span measures it: the hidden-vs-
            exposed wall comes from an untraced run of the same step.
        faults: the chaos plan; off (``NULL_FAULT_PLAN``) by default.  When
            armed, the overlapped stencil asks its ``halo`` site after each
            exchange and applies the drawn fault to the ghosts.
    """

    def __init__(self, cfg: EngineConfig, mesh: MeshSpec | SlabMesh | torch.device | str):
        self.cfg = cfg
        self.mesh = resolve_mesh(mesh)
        self.device = self.mesh.device
        self.n_devices = self.mesh.n_devices
        self.is_ranked = self.mesh.is_ranked
        self.rank, self.world, self.group = self.mesh.rank, self.mesh.world, self.mesh.group
        self.site_axes = dist_sharding.lattice_site_axes(self.mesh)
        self.is_multi_host = dist_sharding.lattice_is_multi_host(self.mesh)
        if cfg.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {cfg.placement!r}; one of {PLACEMENTS}")
        self.codec = layouts.make_codec(
            cfg.layout,
            tile=cfg.tile,
            dtype=cfg.dtype,
            accum_dtype=cfg.accum_dtype,
            compression=layouts.GaugeCompression(cfg.compression),
        )
        self.kernel = registry.get_kernel(cfg.variant)
        # Lattice padded so every (simulated) device's share is whole tiles.
        n = cfg.shape.n_sites
        chunk = self.n_devices * cfg.tile
        self.padded_sites = ((n + chunk - 1) // chunk) * chunk
        if self.world > 1 and self.padded_sites != n:
            raise ValueError(
                f"{self.world} ranks need the L^4 = {n} sites to fill whole tiles of every "
                f"device: the padding unit n_devices * tile = {chunk} pads them to "
                f"{self.padded_sites}; lower the tile")
        self.site_range = self._rank_ranges()[self.rank]
        self.local_sites = self.site_range[1] - self.site_range[0]
        self.step = make_raw_step(self.codec, self.kernel, tile=cfg.tile)
        self._fused_steps: dict[int, Step] = {}
        self._batched_steps: dict[tuple[int, int, bool], Callable[..., torch.Tensor]] = {}
        self._stencil_steps: dict[tuple[bool, int], Step] = {}
        self._geometry: dict[str, Any] | None = None
        self._boundary: dict[str, Any] | None = None
        self._stencil_parts: dict[str, Any] | None = None
        self._nbr_bufs: dict[str, torch.Tensor] = {}
        self._side: torch.cuda.Stream | None = None
        self._cg_help: dict[str, Callable[..., Any]] | None = None
        self._cg_applies: dict[tuple[bool, bool], Callable[..., Any]] = {}
        self.tracer = NULL_TRACER
        self.faults = NULL_FAULT_PLAN

    @property
    def n_hosts(self) -> int:
        """The number of slabs (1 on a single-slab plan)."""
        return self.mesh.hosts

    # -- the ranks ----------------------------------------------------------------

    def _rank_ranges(self) -> list[tuple[int, int]]:
        """Every rank's global site range (one range without a group)."""
        return [dist_sharding.rank_site_range(self.padded_sites, self.n_hosts, self.world, q)
                for q in range(self.world)]

    def _global_rank(self, q: int) -> int:
        return torch.distributed.get_global_rank(self.group, q)

    def gather_ranks(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape on each), in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        torch.distributed.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def every_rank(self, ok: bool) -> bool:
        """``ok`` on every rank (the AND over the group)."""
        if not self.is_ranked:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def _site_count(self, phys: torch.Tensor) -> int:
        if self.codec.layout == Layout.SOA:
            return phys.shape[-1]
        return phys.shape[0] * (self.cfg.tile if self.codec.layout == Layout.AOSOA else 1)

    def _is_local(self, sites: int) -> bool:
        """A tensor of ``sites`` sites holds this rank's only, out of
        several ranks'."""
        return self.world > 1 and sites == self.local_sites

    def _live_sites(self, sites: int) -> int:
        """The live (unpadded) sites among the first ``sites`` of a tensor
        that starts at this rank's ``site_range`` (or at 0 when whole)."""
        lo = self.site_range[0] if self._is_local(sites) else 0
        return max(0, min(lo + sites, self.cfg.shape.n_sites) - lo)

    def local_part(self, phys: torch.Tensor) -> torch.Tensor:
        """This rank's sites of a whole physical lattice (e.g. ``replicated``
        init's A); a tensor that is not whole is returned as it is."""
        if self.world == 1 or self._site_count(phys) != self.padded_sites:
            return phys
        return self._narrow_sites(phys, self.site_range[0], self.local_sites)

    def _narrow_sites(self, phys: torch.Tensor, lo: int, n: int) -> torch.Tensor:
        """Sites ``[lo, lo + n)`` of a physical lattice, contiguous."""
        per = self.cfg.tile if self.codec.layout == Layout.AOSOA else 1
        return phys.narrow(_SITE_DIM[self.codec.layout], lo // per, n // per).contiguous()

    def halo(self) -> dist_sharding.HaloSpec:
        """Boundary geometry of the plan's slabs (gauge words at storage
        width); n_shards = n_hosts."""
        return dist_sharding.HaloSpec(
            L=self.cfg.L, n_shards=self.n_hosts, word_bytes=self.cfg.word_bytes
        )

    def lattice_batch_blocks(self, batch: int) -> list[dist_sharding.BatchBlock]:
        """Where a batch of ``batch`` whole lattices lives (request batches,
        megakernel slot tables): one block per mesh position, host-major,
        on ``mesh.devices``; on ranks only this rank's blocks.  The
        counterpart of the reference's ``lattice_batch_sharding``.

        Raises:
            ValueError: ``batch`` is not a multiple of ``n_devices``.
        """
        return dist_sharding.lattice_batch_blocks(self.mesh, batch)

    def slot_table_blocks(self, slots: int) -> list[dist_sharding.BatchBlock]:
        """The blocks of a ``slots``-slot megakernel table: whole lattices
        per device when ``slots`` divides over the mesh, else (as the
        reference leaves such a table unsharded) the whole table in one
        block on the process's first device."""
        if slots % self.n_devices == 0:
            return self.lattice_batch_blocks(slots)
        return [dist_sharding.BatchBlock(0, self.mesh.devices[0], 0, slots)]

    # -- fused multi-iteration stepping ---------------------------------------

    def fused_step(self, k: int) -> Step:
        """One launch performing K chained multiplies (C fed back as A).

        ``fused_step(k)(a, b)`` equals ``step`` applied k times.  On the card
        a planar kernel writes C into A's storage (in place), so the caller
        rebinds ``a = fused(a, b)`` and must not reuse the old A; the
        reference aliases only on the TPU, and on the CPU neither aliases.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k not in self._fused_steps:
            self._fused_steps[k] = make_raw_step(
                self.codec, self.kernel, tile=self.cfg.tile, k_iters=k,
                alias=self.kernel.form == registry.PLANAR and self.device.type == "cuda",
            )
        return self._fused_steps[k]

    def fused_batched_step(
        self, slots: int, max_k: int = 8, alias: bool | None = None
    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
        """One megakernel launch per block advancing a whole slot table.

        ``fused_batched_step(slots, max_k)(a_batch, b_batch, slot_k)`` equals
        applying ``step`` ``slot_k[s]`` times to slot ``s`` independently —
        bit for bit, since both kernels run one chain body — but every
        slot's chain runs in one launch over (slots x sites) per block of
        :meth:`slot_table_blocks`, so a serving iteration costs one launch
        per device however many chains are in flight.  Per-slot depths are
        data (an int32 tensor beside the table, read by the kernel), clamped
        to ``max_k``; depth 0 passes a slot through.

        When ``slots`` divides over the mesh, the table is split into whole
        lattices per device (the reference's ``lattice_batch_sharding``):
        the arguments are one tensor when the blocks share a device (each
        block's launch reads and writes its rows) or one tensor per device;
        on ranks, the rank's own slots.  Otherwise the whole table runs in
        one launch on the first device, as the reference leaves it
        unsharded.

        ``alias`` writes the table in place: ``None`` means in place on the
        card (the reference donates the table on the TPU) and out of place
        on the CPU.  A caller that must keep the old table — to roll back
        after a poisoned or non-finite dispatch — passes ``alias=False``.

        Args:
            slots: slot-table size (the leading axis of ``a_batch``).
            max_k: in-kernel chain bound; every per-slot depth in
                ``[0, max_k]`` runs in the same launch.
        """
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {max_k}")
        if alias is None:
            alias = self.device.type == "cuda"
        key = (slots, max_k, bool(alias))
        if key not in self._batched_steps:
            kernel = registry.get_kernel(MEGAKERNEL_VARIANT)
            raw = make_raw_batched_step(
                self.codec, kernel, tile=self.cfg.tile, max_k=max_k, alias=bool(alias)
            )
            blocks = self.slot_table_blocks(slots)
            self._batched_steps[key] = lambda a, b, k: _launch_blocks(blocks, raw, bool(alias),
                                                                      a, b, k)
        return self._batched_steps[key]

    # -- nearest-neighbour stencil (Dslash-style) -------------------------------

    def stencil_halo(self, depth: int = 1) -> dist_sharding.HaloSpec:
        """Halo spec of the stencil's vector-field exchange: the slabs'
        boundary geometry at 6 words per site and the plan's storage width;
        ``depth=2`` prices the exchange that feeds two applications."""
        return dist_sharding.HaloSpec(
            L=self.cfg.L,
            n_shards=self.n_hosts,
            word_bytes=self.cfg.word_bytes,
            words_per_site=dist_sharding.VECTOR_WORDS_PER_SITE,
            depth=depth,
        )

    def _stencil_geometry(self) -> dict[str, Any]:
        """The stencil's neighbour geometry on this process's sites, built
        once per plan: the global tables (numpy), this rank's slab-local
        table (local ids, a tensor), its boundary sites (global ids), the
        depth-1 exchange (``halo1``: the +-t ghosts of every rank's boundary
        sites that another rank owns) and the periodic gathers through it."""
        if self._geometry is None:
            glob, local, bidx = stencil_neighbor_tables(self.cfg.L, self.padded_sites,
                                                        self.n_hosts)
            ranges = self._rank_ranges()
            lo, hi = self.site_range

            def boundary(q: int) -> np.ndarray:
                return bidx[(bidx >= ranges[q][0]) & (bidx < ranges[q][1])].astype(np.int64)

            def ring(q: int) -> np.ndarray:
                b = boundary(q)  # the +-t neighbours of q's boundary: its ghosts
                return np.concatenate([glob[3][b], glob[7][b]]).astype(np.int64)

            geo: dict[str, Any] = {"glob": glob, "ring": ring, "mine": boundary(self.rank),
                                   "halo1": self._halo(ring)}
            geo["local"] = torch.from_numpy(local[:, lo:hi].astype(np.int64) - lo).to(self.device)
            geo["periodic"] = [_Gather(*geo["halo1"].locate(glob[d, lo:hi]), self.device)
                               for d in range(8)]
            self._geometry = geo
        return self._geometry

    def _halo(self, reads: Callable[[int], np.ndarray]) -> _Halo:
        """The exchange that brings each rank the sites ``reads(q)`` names
        and another rank owns."""
        ranges = self._rank_ranges()
        needs = []
        for q, (qlo, qhi) in enumerate(ranges):
            ids = reads(q)
            needs.append(np.unique(ids[(ids < qlo) | (ids >= qhi)]))
        return _Halo(needs, ranges, self.rank, self.device, self._global_rank)

    def _post(self, entries: list[_PostEntry]) -> tuple[list[Any], list[list[torch.Tensor]],
                                                        list[torch.Tensor]]:
        """Post one exchange: per entry ``(halo, field, select, slot, rows)``
        send each peer the sites of ``field`` it reads (``select(field,
        idx)``, ``(2, rows, n)``) and receive its sites into the plan's
        buffers ``slot``; one ``batch_isend_irecv`` for every entry, the
        ops in ascending peer order and entry order on every rank (a send
        and its receive pair by that order on NCCL, by the entry's tag on
        gloo).  Returns the works, each entry's receive buffers and the
        posted tensors (the caller keeps them until the works complete)."""
        recvs = [[self._buffer(f"{slot}_recv{j}", (2, rows, n))
                  for j, (_, _, n) in enumerate(halo.peers)]
                 for halo, _, _, slot, rows in entries]
        dist = torch.distributed
        ops = []
        for peer in sorted({q for e in entries for q, _, _ in e[0].peers}):
            for tag, (halo, field, select, _slot, _rows) in enumerate(entries):
                for j, (q, send, n_recv) in enumerate(halo.peers):
                    if q != peer:
                        continue
                    if send.numel():
                        ops.append(dist.P2POp(dist.isend, select(field, send), q, self.group,
                                              tag))
                    if n_recv:
                        ops.append(dist.P2POp(dist.irecv, recvs[tag][j], q, self.group, tag))
        works = dist.batch_isend_irecv(ops) if ops else []
        return works or [], recvs, [op.tensor for op in ops]

    def _buffer(self, slot: str, shape: tuple[int, ...], zero: bool = False) -> torch.Tensor:
        """The plan's reusable block ``slot``, allocated once on the main
        stream; every reuse is ordered by the main stream (the exchange's
        side stream waits on it first, see :meth:`_issue_exchange`)."""
        buf = self._nbr_bufs.get(slot)
        if buf is None:
            make = torch.zeros if zero else torch.empty
            buf = make(shape, dtype=self.codec.word_dtype, device=self.device)
            self._nbr_bufs[slot] = buf
        return buf

    def gather_neighbors(
        self, v_p: torch.Tensor, slot: str = "v", overlap: bool = False
    ) -> torch.Tensor:
        """Fill the plan's (8, 2, 3, local_sites) block ``slot`` with the 8
        shifted copies of ``v_p`` (2, 3, local_sites), direction-major, and
        return it: one ``index_select`` per direction, straight into the
        block.  The block is reused by the next gather into the same slot
        (stream order makes that safe for the kernel that reads it).
        ``overlap`` takes the slab-local table (+-t wrap inside each slab),
        which on one slab is the periodic table.  The periodic gather on
        ranks first exchanges the +-t faces other ranks own (and waits for
        them); the faces fill the +-t directions' boundary columns."""
        geo = self._stencil_geometry()
        buf = self._buffer(slot, (8, 2, layouts.SU3, self.local_sites))
        if overlap:
            for d in range(8):
                torch.index_select(v_p, 2, geo["local"][d], out=buf[d])
            return buf
        recv: list[torch.Tensor] = []
        if geo["halo1"].crosses:
            works, (recv,), _sent = self._post([(geo["halo1"], v_p, _select, f"{slot}_faces",
                                                 layouts.SU3)])
            for w in works:
                w.wait()
        for d, g in enumerate(geo["periodic"]):
            g.local(v_p, buf[d])
            g.remote(recv, buf[d])
        return buf

    def _stencil_kernel_kwargs(
        self, variant: str = STENCIL_VARIANT
    ) -> tuple[registry.KernelEntry, dict[str, Any]]:
        kernel = registry.get_kernel(variant)
        if not kernel.supports_layout(self.codec.layout):
            raise ValueError(
                f"stencil kernel {kernel.name!r} does not support layout "
                f"{self.codec.layout.value!r}"
            )
        if self.codec.is_mixed_precision and not kernel.supports_accum_dtype():
            raise ValueError(
                f"stencil kernel {kernel.name!r} cannot accumulate at "
                f"{self.codec.accum_dtype!r} over {self.codec.dtype!r} storage"
            )
        if self.codec.is_compressed and not kernel.supports_compression():
            raise ValueError(
                f"stencil kernel {kernel.name!r} cannot stream two-row "
                f"compressed gauge (no reconstruct-on-load path)"
            )
        kw: dict[str, Any] = {"tile": self.cfg.tile}
        if self.codec.is_mixed_precision:
            kw["accum_dtype"] = self.codec.accum_dtype
        if self.codec.is_compressed:
            kw["compressed"] = True
        return kernel, kw

    def raw_stencil_reference(self) -> Step:
        """``(u_phys, v_p) -> out_p``: gather all 8 neighbour fields through
        the periodic table, then ONE kernel pass over every site (the
        physical links are read in place, AoSoA included).  The serial step
        and the bit-identity oracle of the overlapped schedules."""
        kernel, kw = self._stencil_kernel_kwargs()

        def reference(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
            return kernel.fn(u_phys, self.gather_neighbors(v_p, "v"), **kw)

        return reference

    def stencil_reference_step(self) -> Step:
        """The non-overlapped stencil step (the serial path)."""
        return self.stencil_step(overlap=False)

    def stencil_step(self, overlap: bool | None = None, depth: int = 1) -> Step:
        """The stencil dispatch path: ``step(u_phys, v_p) -> out_p``.

        ``u_phys`` is the plan's physical gauge lattice, ``v_p`` the planar
        (2, 3, padded_sites) vector field (``codec.pack_vec``); the result
        is the planar output field.  ``depth`` applications run per call
        (depth=2 equals two depth-1 steps, bit for bit).

        overlap=False is the serial path: the periodic gather, then the
        kernel over all sites.  overlap=True (the default on several slabs)
        is the reference's split schedule:

        1. **exchange** — copy the +-t ghost faces of every slab (the true
           neighbours of its boundary sites) into their own buffers, on a
           side CUDA stream;
        2. **interior** — meanwhile, on the main stream, the kernel over
           every site with the +-t gathers wrapped inside each slab: every
           interior site is already exact;
        3. **boundary** — after the exchange's event, recompute the boundary
           sites (2 L^3 per slab, padded to the tile) from the true ghosts
           and copy them over the interior output.

        The boundary sites are computed twice (the classic overlap trade);
        the bits are the serial step's: same kernel, same per-site inputs.
        On one slab there is no boundary and overlap=True is the single
        slab-local pass.  depth=2 with overlap runs the communication-
        avoiding ring (:meth:`_build_stencil_step2`).
        """
        if depth not in (1, 2):
            raise ValueError(f"stencil exchange depth must be 1 or 2, got {depth}")
        if overlap is None:
            overlap = self.is_multi_host
        key = (bool(overlap), depth)
        if key not in self._stencil_steps:
            self._stencil_steps[key] = self._build_stencil_step(*key)
        return self._stencil_steps[key]

    # -- the multi-slab schedules -------------------------------------------------

    def _sync(self) -> None:
        _synchronize(self.device)

    def _issue_exchange(
        self, copy: Callable[[], tuple[tuple[torch.Tensor, ...], Callable[[], None] | None]]
    ) -> tuple[tuple[torch.Tensor, ...], tuple[Any, Callable[[], None] | None]]:
        """Run ``copy`` (an exchange) on the plan's side stream and return
        its ghosts and what the boundary pass awaits.

        ``copy`` gathers the ghosts' local columns, posts the sends and
        receives of what crosses ranks, and returns the ghost tensors and
        ``finish`` (``None`` when nothing crosses), which waits for the
        receives and fills the ghosts' remote columns.  The side stream
        first waits on everything queued on the main stream so far: the
        fields it reads are ready, and the last boundary pass has finished
        reading the buffers this exchange refills.  Work the caller queues
        on the main stream afterwards (the interior pass) runs alongside.
        On the CPU: ``copy()`` in program order, no event.
        """
        if self.device.type != "cuda":
            ghosts, finish = copy()
            return ghosts, (None, finish)
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            ghosts, finish = copy()
            done = torch.cuda.Event()
            done.record(self._side)
        return ghosts, (done, finish)

    def _await_exchange(self, pending: tuple[Any, Callable[[], None] | None]) -> None:
        """Order the main stream after an exchange: its side-stream event,
        then (on ranks) the receives, ``work.wait()`` ordering the current
        stream on NCCL, and the ghosts' remote columns."""
        done, finish = pending
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        if finish is not None:
            finish()

    def _exchange_ghosts(
        self, fields: tuple[tuple[str, torch.Tensor], ...], halo: _Halo,
        gathers: list[tuple[int, _Gather, torch.Tensor]], extra: tuple = (),
    ) -> tuple[tuple[torch.Tensor, ...], Callable[[], None] | None]:
        """One exchange (the ``copy`` of :meth:`_issue_exchange`): each
        ``(field index, gather, ghost buffer)`` gets its local columns now;
        when the exchange crosses ranks the ``(slot, field)`` sites other
        ranks read, and any ``extra`` :meth:`_post` entries, are posted in
        one ``batch_isend_irecv`` and ``finish`` fills the remote columns
        from the received faces."""
        values = [f for _, f in fields]
        for i, gather, out in gathers:
            gather.local(values[i], out)
        ghosts = tuple(out for _, _, out in gathers)
        if not (halo.crosses or any(e[0].crosses for e in extra)):
            return ghosts, None
        works, recvs, sent = self._post([(halo, f, _select, slot, layouts.SU3)
                                         for slot, f in fields] + list(extra))

        def finish() -> None:
            for w in works:
                w.wait()
            for i, gather, out in gathers:
                gather.remote(recvs[i], out)
            sent.clear()  # the sent faces lived until their sends completed

        return ghosts, finish

    def _halo_fault(self, ghosts: tuple[torch.Tensor, ...], depth: int) -> tuple[torch.Tensor, ...]:
        """The ``halo`` chaos seam on an exchange's received ghosts (callers
        guard it with ``if self.faults.enabled``)."""
        f = self.faults.ask("halo", depth=depth)
        return ghosts if f is None else corrupt_ghosts(ghosts, f.action)

    def _site_links(self, u_phys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The links at sites ``idx`` as planar SoA (2, rows, len(idx)),
        which the kernels take whatever the plan's layout; AoSoA is read
        through its tiles."""
        if self.codec.layout == Layout.AOSOA:
            t = self.cfg.tile
            return torch.movedim(u_phys[idx // t, :, :, idx % t], 0, 2).contiguous()
        return u_phys.index_select(2, idx)

    def _boundary_geometry(self) -> dict[str, Any]:
        """Index sets of the boundary passes, shared by the stencil and CG
        schedules: this rank's boundary sites ``bidx`` (B, local ids), their
        +-t true neighbours ``fwd`` and ``bwd`` (global ids, numpy: the
        ghosts, which ``ghost_fwd`` and ``ghost_bwd`` gather through the
        depth-1 exchange), and, padded to Bp sites by :func:`_pad_to_tile`,
        the site list ``bidx_pad`` and the in-slab neighbours ``xyz`` (6,
        Bp, local ids)."""
        if self._boundary is None:
            geo = self._stencil_geometry()
            glob, mine, lo, dev = geo["glob"], geo["mine"], self.site_range[0], self.device
            bidx = torch.from_numpy(mine - lo).to(dev)
            xyz = torch.from_numpy(glob[[0, 1, 2, 4, 5, 6]][:, mine].astype(np.int64) - lo)
            fwd, bwd = glob[3][mine].astype(np.int64), glob[7][mine].astype(np.int64)
            self._boundary = {
                "n": mine.size,
                "bidx": bidx,
                "bidx_pad": _pad_to_tile(bidx, self.cfg.tile),
                "fwd": fwd,
                "bwd": bwd,
                "xyz": _pad_to_tile(xyz.to(dev), self.cfg.tile),
                "ghost_fwd": _Gather(*geo["halo1"].locate(fwd), dev),
                "ghost_bwd": _Gather(*geo["halo1"].locate(bwd), dev),
            }
        return self._boundary

    def _boundary_nbr(self, v_p: torch.Tensor, ghost_fwd: torch.Tensor,
                      ghost_bwd: torch.Tensor, slot: str) -> torch.Tensor:
        """The (8, 2, 3, Bp) neighbour block of the boundary sites: the six
        in-slab directions gathered from ``v_p``, +-t from the ghosts (whose
        padding columns stay the zeros the block was made with)."""
        g = self._boundary_geometry()
        n = g["n"]
        buf = self._buffer(slot, (8, 2, layouts.SU3, g["bidx_pad"].numel()), zero=True)
        for j, d in enumerate((0, 1, 2, 4, 5, 6)):
            torch.index_select(v_p, 2, g["xyz"][j], out=buf[d])
        buf[3, :, :, :n].copy_(ghost_fwd)
        buf[7, :, :, :n].copy_(ghost_bwd)
        return buf

    def _stencil_overlap_parts(self) -> dict[str, Any]:
        """The pieces every overlapped stencil schedule shares, built once,
        so the depth-2 ring reuses the depth-1 interior and boundary passes
        and its bit-identity needs to cover only the ring recompute."""
        if self._stencil_parts is not None:
            return self._stencil_parts
        kernel, kw = self._stencil_kernel_kwargs()

        def interior(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
            # slab-local gathers only: independent of the exchange in flight
            return kernel.fn(u_phys, self.gather_neighbors(v_p, "v", overlap=True), **kw)

        parts: dict[str, Any] = {"interior": interior,
                                 "n_boundary": self._stencil_geometry()["mine"].size}
        if parts["n_boundary"]:
            g = self._boundary_geometry()
            n = g["n"]
            ghosts = [(0, g["ghost_fwd"], self._buffer("ghost_fwd", (2, layouts.SU3, n))),
                      (0, g["ghost_bwd"], self._buffer("ghost_bwd", (2, layouts.SU3, n)))]
            halo = self._stencil_geometry()["halo1"]

            def exchange(v_p: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], Any]:
                return self._exchange_ghosts((("ghost", v_p),), halo, ghosts)

            def boundary(u_phys: torch.Tensor, v_p: torch.Tensor, ghost_fwd: torch.Tensor,
                         ghost_bwd: torch.Tensor, out_interior: torch.Tensor) -> torch.Tensor:
                v_nbr = self._boundary_nbr(v_p, ghost_fwd, ghost_bwd, "v_boundary")
                out_b = kernel.fn(self._site_links(u_phys, g["bidx_pad"]), v_nbr, **kw)
                # an indexed copy: the boundary kernel's bits, unchanged
                return out_interior.index_copy_(2, g["bidx"], out_b[:, :, :n])

            parts.update(exchange=exchange, boundary=boundary)
        self._stencil_parts = parts
        return parts

    def _stencil_trace_attrs(self, overlap: bool, depth: int) -> dict[str, Any]:
        """Attrs every ``stencil.step`` span carries: the key the
        attribution report joins against ``autotune.predict_stencil``."""
        cfg = self.cfg
        return {
            "L": cfg.L, "tile": cfg.tile, "dtype": cfg.dtype,
            "compression": cfg.compression, "hosts": self.n_hosts,
            "overlap": bool(overlap), "depth": depth,
            "flops": float(STENCIL_FLOPS_PER_SITE) * cfg.shape.n_sites * depth,
        }

    def _build_stencil_step(self, overlap: bool, depth: int = 1) -> Step:
        plan = self  # the closures read plan.tracer / plan.faults at call time
        if not overlap:
            ref = self.raw_stencil_reference()
            attrs = self._stencil_trace_attrs(False, depth)

            def serial(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
                tr = plan.tracer
                if not tr.enabled:
                    if depth == 1:
                        return ref(u_phys, v_p)
                    return ref(u_phys, ref(u_phys, v_p))
                with tr.span("stencil.step", **attrs):
                    out = ref(u_phys, v_p)
                    if depth == 2:
                        out = ref(u_phys, out)
                    plan._sync()
                return out

            return serial

        parts = self._stencil_overlap_parts()
        interior = parts["interior"]
        attrs = self._stencil_trace_attrs(True, depth)
        rank = {"rank": self.rank}
        if parts["n_boundary"] == 0:
            # one slab: the local wrap is the periodic wrap and there is no
            # exchange; depth composes the interior pass

            def local_only(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
                tr = plan.tracer
                if not tr.enabled:
                    if depth == 1:
                        return interior(u_phys, v_p)
                    return interior(u_phys, interior(u_phys, v_p))
                with tr.span("stencil.step", **attrs):
                    for _ in range(depth):
                        with tr.span("stencil.interior", **rank):
                            v_p = interior(u_phys, v_p)
                            plan._sync()
                return v_p

            return local_only

        exchange, boundary = parts["exchange"], parts["boundary"]
        if depth == 2:
            return self._build_stencil_step2(parts)

        def overlapped(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
            tr = plan.tracer
            if not tr.enabled:
                ghosts, pending = plan._issue_exchange(lambda: exchange(v_p))  # issued first
                out_i = interior(u_phys, v_p)  # alongside the exchange
                plan._await_exchange(pending)
                if plan.faults.enabled:
                    ghosts = plan._halo_fault(ghosts, 1)
                return boundary(u_phys, v_p, *ghosts, out_i)
            # traced: each phase synchronizes so its span is a measurement
            with tr.span("stencil.step", **attrs):
                with tr.span("stencil.exchange", **rank):
                    ghosts, pending = plan._issue_exchange(lambda: exchange(v_p))
                    plan._await_exchange(pending)
                    plan._sync()
                if plan.faults.enabled:
                    ghosts = plan._halo_fault(ghosts, 1)
                with tr.span("stencil.interior", **rank):
                    out_i = interior(u_phys, v_p)
                    plan._sync()
                with tr.span("stencil.boundary", **rank):
                    out = boundary(u_phys, v_p, *ghosts, out_i)
                    plan._sync()
            return out

        return overlapped

    def _build_stencil_step2(self, parts: dict[str, Any]) -> Step:
        """The communication-avoiding double step (overlap, depth=2).

        The ring is the (+t, -t) neighbours of the boundary sites: exactly
        the sites whose step-1 results step 2's boundary pass reads as
        ghosts.  ``exchange2`` brings the whole depth-2 payload at once
        (the depth-1 ghosts and the 8-direction ``v`` neighbourhoods of the
        ring; on ranks also the links of the ring sites another rank owns,
        in the same ``batch_isend_irecv``); ``ring`` then recomputes step
        1's output at the ring from it, so step 2 never exchanges.  A ring
        site is either interior to its slab (step 1 computed it through the
        local table, which equals the periodic table there) or a boundary
        site (step 1 computed it from the periodic ghosts): either way the
        recompute feeds the kernel the same per-site inputs, hence the bits
        of two depth-1 steps.
        """
        plan = self
        kernel, kw = self._stencil_kernel_kwargs()
        geo = self._stencil_geometry()
        glob, ring_of = geo["glob"], geo["ring"]
        g = self._boundary_geometry()
        interior, boundary = parts["interior"], parts["boundary"]
        n, rows, dev = g["n"], self.codec.planar_rows, self.device
        ridx = _pad_ids(ring_of(self.rank), self.cfg.tile)  # (2B + pad) global ids
        # the depth-2 payload: v at the ghosts and at every site the ring
        # reads, and the ring's links
        halo_v = self._halo(lambda q: np.concatenate([ring_of(q), glob[:, ring_of(q)].ravel()]))
        halo_u = self._halo(ring_of)
        ghosts = [(0, _Gather(*halo_v.locate(g["fwd"]), dev),
                   self._buffer("ghost_fwd", (2, layouts.SU3, n))),
                  (0, _Gather(*halo_v.locate(g["bwd"]), dev),
                   self._buffer("ghost_bwd", (2, layouts.SU3, n)))]
        ring_buf = self._buffer("ring", (8, 2, layouts.SU3, ridx.size))
        ghosts += [(0, _Gather(*halo_v.locate(glob[d, ridx]), dev), ring_buf[d])
                   for d in range(8)]
        links = _Gather(*halo_u.locate(ridx), dev)
        ridx_local = torch.from_numpy(ridx - self.site_range[0]).to(dev)
        u_ring = None if links.all_local else self._buffer("ring_links", (2, rows, ridx.size))
        u_recv = [self._buffer(f"ring_u_recv{j}", (2, rows, m))
                  for j, (_, _, m) in enumerate(halo_u.peers)]
        attrs = self._stencil_trace_attrs(True, 2)
        rank = {"rank": self.rank}

        def exchange2(u_phys: torch.Tensor, v_p: torch.Tensor) -> tuple[tuple, Any]:
            out, finish = self._exchange_ghosts(
                (("ring_v", v_p),), halo_v, ghosts,
                extra=((halo_u, u_phys, self._site_links, "ring_u", rows),))
            return (out[0], out[1], ring_buf), finish

        def ring(u_phys: torch.Tensor, ring_vnbr: torch.Tensor) -> tuple[torch.Tensor, ...]:
            if u_ring is None:
                u_r = self._site_links(u_phys, ridx_local)
            else:
                links.local(u_phys, u_ring, self._site_links)
                links.remote(u_recv, u_ring)
                u_r = u_ring
            w_r = kernel.fn(u_r, ring_vnbr, **kw)
            # step 1's output at the (+t, -t) neighbours of the boundary:
            # the ghosts step 2's boundary pass would otherwise exchange
            return w_r[:, :, :n], w_r[:, :, n:2 * n]

        def overlapped2(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
            tr = plan.tracer
            if not tr.enabled:
                payload, pending = plan._issue_exchange(lambda: exchange2(u_phys, v_p))
                out_1i = interior(u_phys, v_p)  # alongside the exchange
                plan._await_exchange(pending)
                if plan.faults.enabled:
                    payload = plan._halo_fault(payload, 2)
                g_fwd, g_bwd, ring_vnbr = payload
                w = boundary(u_phys, v_p, g_fwd, g_bwd, out_1i)
                ring_w = ring(u_phys, ring_vnbr)  # recompute, don't re-exchange
                out_2i = interior(u_phys, w)
                return boundary(u_phys, w, *ring_w, out_2i)
            with tr.span("stencil.step", **attrs):
                with tr.span("stencil.exchange", **rank):
                    payload, pending = plan._issue_exchange(lambda: exchange2(u_phys, v_p))
                    plan._await_exchange(pending)
                    plan._sync()
                if plan.faults.enabled:
                    payload = plan._halo_fault(payload, 2)
                g_fwd, g_bwd, ring_vnbr = payload
                with tr.span("stencil.interior", **rank):
                    out_1i = interior(u_phys, v_p)
                    plan._sync()
                with tr.span("stencil.boundary", **rank):
                    w = boundary(u_phys, v_p, g_fwd, g_bwd, out_1i)
                    plan._sync()
                with tr.span("stencil.ring", **rank):
                    ring_w = ring(u_phys, ring_vnbr)
                    plan._sync()
                with tr.span("stencil.interior", **rank):
                    out_2i = interior(u_phys, w)
                    plan._sync()
                with tr.span("stencil.boundary", **rank):
                    out = boundary(u_phys, w, *ring_w, out_2i)
                    plan._sync()
            return out

        return overlapped2

    def init_stencil_data(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The canonical stencil inputs ``(u_phys, v_p)`` under the plan's
        placement (this rank's sites on ranks): U entries (1, 0), v entries
        (1/24, 0), so every output component of the stencil is exactly
        (1, 0)."""
        a_phys, _b, _init_s, _scatter_s = self.init_data()
        _, v = init_stencil_canonical(self._live_sites(self.local_sites), self.device)
        return self.local_part(a_phys), self.codec.pack_vec(v, self.local_sites)

    def unpack_vec(self, out_p: torch.Tensor) -> torch.Tensor:
        """Planar stencil output -> canonical complex (n_sites, 3); on ranks
        every rank's sites, gathered, so a check reads the same field on
        every rank."""
        if self._is_local(out_p.shape[-1]):
            out_p = torch.cat(self.gather_ranks(out_p), dim=2)
        return self.codec.unpack_vec(out_p, self.cfg.shape.n_sites)

    def _rank_slice(self, x: torch.Tensor | np.ndarray) -> torch.Tensor:
        """A canonical field's sites ``[lo, hi)`` of this rank (all of it
        without a group), zero-padded to ``local_sites``, on the device."""
        x = torch.as_tensor(x)
        lo, hi = self.site_range
        x = x[lo:min(hi, x.shape[0])].to(self.device)
        if x.shape[0] < self.local_sites:
            pad = torch.zeros((self.local_sites - x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=self.device)
            x = torch.cat([x, pad])
        return x

    def pack_gauge(self, u: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Canonical complex ``(n_sites, 4, 3, 3)`` gauge field (tensor or
        numpy) -> the physical layout on the plan's device, zero-padded to
        ``padded_sites``; on ranks the whole field goes in and this rank's
        ``site_range`` comes out.  Padding sites self-neighbour in the
        tables and carry zero links, so they add nothing to any stencil or
        CG output."""
        phys = self.codec.pack(self._rank_slice(u)).contiguous()
        lo = self.site_range[0]
        if self.codec.layout == Layout.AOS and lo:  # the metadata's global site ids
            meta = _uniform_phys_shard(self.codec, self.local_sites, lo)[:, layouts.GAUGE_WORDS:]
            phys[:, layouts.GAUGE_WORDS:] = torch.from_numpy(meta)
        return phys

    def pack_rhs(self, b: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Canonical complex ``(n_sites, 3)`` vector field (tensor or numpy)
        -> planar ``(2, 3, local_sites)`` on the plan's device (zero padding
        keeps every CG reduction over the padded array exact)."""
        return self.codec.pack_vec(self._rank_slice(b), self.local_sites)

    def verify_stencil(self, out_p: torch.Tensor) -> bool:
        """Fixed-point check for :meth:`init_stencil_data` inputs: every
        output component is (1, 0) within the storage dtype's tolerance.

        Two-row plans see another fixed point: the uniform lattice is not
        SU(3), so the rebuilt row 2 is ``conj(r0 x r1) = 0`` and the sum is
        ``4 (U + U^T) v = (5/6, 5/6, 1/3)`` per component, computed here
        from the rebuilt link.
        """
        c = self.codec.unpack_vec(out_p, self._live_sites(out_p.shape[-1]))
        if self.codec.is_compressed:
            u = np.ones((layouts.SU3, layouts.SU3))
            u[2] = 0.0  # rebuilt uniform link: row 2 = conj(r0 x r1) = 0
            want = layouts.LINKS * (u + u.T) @ np.full(layouts.SU3, 1.0 / 24.0)
            expected = torch.tensor(want, dtype=torch.float32, device=c.device)
        else:
            expected = torch.tensor(1.0, dtype=torch.float32, device=c.device)
        tol = verify_tolerance(
            self.cfg.dtype, self.cfg.accum_dtype, reconstruct=self.codec.is_compressed
        )
        return self.every_rank(bool(
            torch.max(torch.abs(c.real - expected)).item() < tol
            and torch.max(torch.abs(c.imag)).item() < tol
        ))

    # -- conjugate-gradient solver (fused stencil+axpy iteration) ---------------

    def _cg_helpers(self) -> dict[str, Callable[..., Any]]:
        """The scalar and elementwise CG pieces, plain torch, shared verbatim
        by the fused and composed paths: alpha, beta, the x/r updates and
        both reductions are the same calls on both, so fused and composed
        iterates match bit for bit at f32.  On ranks each reduction is this
        rank's partial sum, gathered from every rank and added in rank
        order, so every rank holds the same scalars.  Every product and sum is its own
        tensor op (no ``add(alpha=)``, ``addcmul`` or ``lerp``), so nothing
        contracts into an FMA that the fused kernel does not do."""
        if self._cg_help is not None:
            return self._cg_help
        f32, dev = torch.float32, self.device

        def scalar(x: torch.Tensor | float) -> torch.Tensor:
            if isinstance(x, torch.Tensor):
                return x.to(f32)
            return torch.full((), float(x), dtype=f32, device=dev)  # a fill, no copy

        def total(partial: torch.Tensor) -> torch.Tensor:
            # on ranks: every rank's partial sum, added in rank order (the
            # bits do not depend on the collective's algorithm; at world 1
            # the partial is the whole sum)
            if not self.is_ranked:
                return partial
            parts = self.gather_ranks(partial.reshape(1))
            out = parts[0]
            for x in parts[1:]:
                out = out + x
            return out.reshape(())

        def rr(v: torch.Tensor) -> torch.Tensor:
            v = v.to(f32)
            return total(torch.sum(v * v))

        def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return total(torch.sum(a.to(f32) * b.to(f32)))

        def update(x, r, p, ap, alpha):
            a = alpha.to(f32)
            return (
                (x.to(f32) + a * p.to(f32)).to(x.dtype),
                (r.to(f32) - a * ap.to(f32)).to(r.dtype),
            )

        def axpy(r, beta, p):  # composed-path search-direction update
            return (r.to(f32) + beta.to(f32) * p.to(f32)).to(r.dtype)

        def shift(p, sigma, s):  # the shifted apply's epilogue, both paths
            return (sigma.to(f32) * p.to(f32) + s.to(f32)).to(p.dtype)

        def coef(beta, sigma):
            return torch.stack([scalar(beta), scalar(sigma)]).reshape(1, 2)

        self._cg_help = {
            "rr": rr, "dot": dot, "update": update, "axpy": axpy, "shift": shift,
            "scal": lambda num, den: num / den, "coef": coef, "scalar": scalar,
            "init": lambda b: (torch.zeros_like(b), b, b),
        }
        return self._cg_help

    def _cg_apply(self, fused: bool, overlap: bool) -> Callable[..., Any]:
        """The per-iteration apply ``(u_phys, r_p, p_p, coefs) -> (p', ap)``
        with ``p' = r + beta p`` and ``ap = sigma p' + S(p')``.

        fused=True: gather r and p, then ONE fused kernel launch forms p' at
        the centre and the neighbours and writes ``(p', S(p'))``; the sigma
        shift runs in the shared epilogue.  On several slabs with
        ``overlap`` the pass splits like :meth:`stencil_step`: the +-t
        ghosts of BOTH r and p are copied on the side stream, the fused pass
        runs over every site through the slab-local tables meanwhile (p' is
        elementwise, so its p' is already exact everywhere), and a boundary
        pass recomputes S(p') at the boundary sites and copies only that
        over.  fused=False: the shared axpy, then ``stencil_step(overlap)``,
        then the same epilogue.
        """
        key = (bool(fused), bool(overlap))
        if key in self._cg_applies:
            return self._cg_applies[key]
        plan = self
        h = self._cg_helpers()

        if not fused:
            step = self.stencil_step(overlap=overlap)

            def composed(u_phys, r_p, p_p, coefs):
                beta, sigma = coefs[0, 0], coefs[0, 1]
                p_new = h["axpy"](r_p, beta, p_p)
                return p_new, h["shift"](p_new, sigma, step(u_phys, p_new))

            self._cg_applies[key] = composed
            return composed

        kernel, kw = self._stencil_kernel_kwargs(CG_VARIANT)

        def whole(u_phys, r_p, p_p, coefs):
            r_nbr = self.gather_neighbors(r_p, "r", overlap)
            p_nbr = self.gather_neighbors(p_p, "p", overlap)
            return kernel.fn(u_phys, r_nbr, p_nbr, r_p, p_p, coefs, **kw)

        if not (overlap and self.is_multi_host):
            # one slab (or overlap off): one fused pass, nothing to exchange

            def fused_whole(u_phys, r_p, p_p, coefs):
                tr = plan.tracer
                if not tr.enabled:
                    p_new, s = whole(u_phys, r_p, p_p, coefs)
                    return p_new, h["shift"](p_new, coefs[0, 1], s)
                with tr.span("cg.interior", rank=plan.rank):
                    p_new, s = whole(u_phys, r_p, p_p, coefs)
                    plan._sync()
                return p_new, h["shift"](p_new, coefs[0, 1], s)

            self._cg_applies[key] = fused_whole
            return fused_whole

        # the overlap schedule: the stencil's geometry, but the exchange
        # copies the ghosts of both fields (p' at a ghost site is r + beta p,
        # formed in the kernel, never exchanged); the boundary pass writes
        # the raw S(p') and the sigma shift runs once on the merged field
        g = self._boundary_geometry()
        n, wd = g["n"], (2, layouts.SU3, g["n"])
        halo = self._stencil_geometry()["halo1"]
        ghosts = [(i, g[f"ghost_{side}"], self._buffer(f"cg_{k}_g{side[0]}", wd))
                  for i, k in enumerate("rp") for side in ("fwd", "bwd")]

        def exchange(r_p, p_p):
            return self._exchange_ghosts((("cg_r", r_p), ("cg_p", p_p)), halo, ghosts)

        def boundary(u_phys, r_p, p_p, r_gf, r_gb, p_gf, p_gb, coefs, s_i):
            r_nbr = self._boundary_nbr(r_p, r_gf, r_gb, "r_boundary")
            p_nbr = self._boundary_nbr(p_p, p_gf, p_gb, "p_boundary")
            r_b, p_b = r_p.index_select(2, g["bidx_pad"]), p_p.index_select(2, g["bidx_pad"])
            _p_new_b, s_b = kernel.fn(self._site_links(u_phys, g["bidx_pad"]), r_nbr, p_nbr,
                                      r_b, p_b, coefs, **kw)
            return s_i.index_copy_(2, g["bidx"], s_b[:, :, :n])

        def fused_overlapped(u_phys, r_p, p_p, coefs):
            tr = plan.tracer
            if not tr.enabled:
                ghosts, pending = plan._issue_exchange(lambda: exchange(r_p, p_p))
                p_new, s_i = whole(u_phys, r_p, p_p, coefs)  # slab-local, alongside
                plan._await_exchange(pending)
                s = boundary(u_phys, r_p, p_p, *ghosts, coefs, s_i)
                return p_new, h["shift"](p_new, coefs[0, 1], s)
            with tr.span("cg.exchange", rank=plan.rank):
                ghosts, pending = plan._issue_exchange(lambda: exchange(r_p, p_p))
                plan._await_exchange(pending)
                plan._sync()
            with tr.span("cg.interior", rank=plan.rank):
                p_new, s_i = whole(u_phys, r_p, p_p, coefs)
                plan._sync()
            with tr.span("cg.boundary", rank=plan.rank):
                s = boundary(u_phys, r_p, p_p, *ghosts, coefs, s_i)
                plan._sync()
            return p_new, h["shift"](p_new, coefs[0, 1], s)

        self._cg_applies[key] = fused_overlapped
        return fused_overlapped

    def cg_state_init(
        self,
        b_p: torch.Tensor,
        x0_p: torch.Tensor | None = None,
        *,
        u_phys: torch.Tensor | None = None,
        sigma: float = CG_SHIFT,
        fused: bool = True,
        overlap: bool | None = None,
    ) -> dict[str, Any]:
        """Initial CG state for the planar right-hand side ``b_p``: x = 0,
        r = b, p-seed = b, beta = 0, so the first :meth:`cg_iterate` forms
        ``p_1 = b``.

        With ``x0_p`` (e.g. ``err.result.x_p`` off a :class:`CGError`) this
        restarts: ``r_0 = b - A x_0`` through the same apply and epilogue as
        the iterations (``u_phys`` is needed for it), and the search
        direction reseeds from ``r_0``.

        Raises:
            ValueError: ``x0_p`` without ``u_phys``.
        """
        h = self._cg_helpers()
        if x0_p is None:
            x, r, p = h["init"](b_p)
            return {"x": x, "r": r, "p": p, "rs": h["rr"](r),
                    "beta": h["scalar"](0.0), "iterations": 0}
        if u_phys is None:
            raise ValueError("resuming cg_state_init from x0_p needs u_phys "
                             "to form r0 = b - A x0")
        if overlap is None:
            overlap = self.is_multi_host
        apply_fn = self._cg_apply(fused, bool(overlap))
        zeros, _r, _p = h["init"](b_p)
        # beta = 0 makes the apply's p' = x0 exactly, so ap = A x0
        _x0, ax0 = apply_fn(u_phys, x0_p, zeros, h["coef"](0.0, sigma))
        # the shared update with p = 0, alpha = 1: x stays x0, r = b - A x0
        x, r = h["update"](x0_p, b_p, zeros, ax0, h["scalar"](1.0))
        return {"x": x, "r": r, "p": r, "rs": h["rr"](r),
                "beta": h["scalar"](0.0), "iterations": 0}

    def cg_iterate(
        self,
        u_phys: torch.Tensor,
        state: dict[str, Any],
        *,
        sigma: float = CG_SHIFT,
        fused: bool = True,
        overlap: bool | None = None,
    ) -> dict[str, Any]:
        """Advance the CG state by ONE iteration.  Everything stays on the
        device (beta and sigma travel in ``coefs``, nothing is fetched); the
        caller decides when to read ``state["rs"]``.  ``overlap=None`` is
        the overlap schedule on several slabs, the single pass on one."""
        if overlap is None:
            overlap = self.is_multi_host
        h = self._cg_helpers()
        apply_fn = self._cg_apply(fused, bool(overlap))
        coefs = h["coef"](state["beta"], sigma)
        p, ap = apply_fn(u_phys, state["r"], state["p"], coefs)
        alpha = h["scal"](state["rs"], h["dot"](p, ap))
        x, r = h["update"](state["x"], state["r"], p, ap, alpha)
        rs_new = h["rr"](r)
        return {
            "x": x, "r": r, "p": p, "rs": rs_new,
            "beta": h["scal"](rs_new, state["rs"]),
            "iterations": state["iterations"] + 1,
        }

    def cg_solve(
        self,
        u_phys: torch.Tensor,
        b_p: torch.Tensor,
        *,
        tol: float = 1e-6,
        max_iters: int = 200,
        sigma: float = CG_SHIFT,
        fused: bool = True,
        overlap: bool | None = None,
        x0_p: torch.Tensor | None = None,
    ) -> CGResult:
        """Conjugate gradients on ``A = sigma I + S`` to ``||r|| <= tol ||b||``.

        Each iteration is two neighbour gathers and one fused stencil+axpy
        launch (``fused=True``; ``fused=False`` composes the axpy and
        ``stencil_step``, the bit-identity oracle) plus the shared epilogue.
        Convergence is checked one iteration LATE: iteration ``i+1`` is
        issued before iteration ``i``'s residual reaches the host (a copy
        that waits for iteration ``i`` only), so at most one extra iteration
        runs past convergence.  With the tracer on, each iteration is a
        ``cg.iter`` span that synchronizes at its end and each residual
        fetch a ``cg.reduce`` span.

        Args:
            u_phys: the plan's physical gauge lattice (``pack_gauge`` form).
            b_p: planar right-hand side ``(2, 3, padded_sites)`` (``pack_rhs``).
            tol: relative residual target.
            max_iters: hard bound; exhaustion raises :class:`CGMaxItersError`.
            sigma: SPD shift (see :data:`CG_SHIFT`).
            fused / overlap: iteration body selection, as above.
            x0_p: optional warm start, via :meth:`cg_state_init`.

        Raises:
            CGMaxItersError: tolerance not reached within ``max_iters``;
                ``err.result`` carries the best iterate for resume.
            CGDivergedError: NaN/Inf residual or blow-up past
                :data:`CG_DIVERGENCE_FACTOR` x ``||b||^2``, with the best
                iterate.
        """
        tr = self.tracer
        h = self._cg_helpers()
        t0 = time.perf_counter()
        b_rs = float(h["rr"](b_p))
        if b_rs == 0.0:
            x, _r, _p = h["init"](b_p)
            return CGResult(x_p=x, iterations=0, residuals=[], converged=True,
                            wall_s=time.perf_counter() - t0)
        if not math.isfinite(b_rs):
            raise CGDivergedError(0, float("nan"), tol, reason="non-finite right-hand side")
        stop2 = (tol * tol) * b_rs
        state = self.cg_state_init(b_p, x0_p, u_phys=u_phys, sigma=sigma,
                                   fused=fused, overlap=overlap)
        residuals: list[float] = []
        prev: tuple[torch.Tensor, Callable[[], float]] | None = None  # (x_i, rs_i later)
        best: tuple[torch.Tensor, float, int] | None = None  # (x, rs_host, iter)

        def partial(iterations: int) -> CGResult | None:
            if best is None:
                return None
            return CGResult(x_p=best[0], iterations=iterations,
                            residuals=list(residuals), converged=False,
                            wall_s=time.perf_counter() - t0)

        def check(rs_host: float, x: torch.Tensor, it: int) -> None:
            nonlocal best
            if not math.isfinite(rs_host):
                raise CGDivergedError(it, float("nan"), tol, partial(it),
                                      reason="non-finite residual")
            if rs_host > CG_DIVERGENCE_FACTOR * b_rs:
                raise CGDivergedError(it, (rs_host / b_rs) ** 0.5, tol, partial(it))
            if best is None or rs_host < best[1]:
                best = (x, rs_host, it)

        for i in range(1, max_iters + 1):
            if tr.enabled:
                with tr.span("cg.iter", it=i, fused=bool(fused)):
                    state = self.cg_iterate(u_phys, state, sigma=sigma, fused=fused,
                                            overlap=overlap)
                    self._sync()
            else:
                state = self.cg_iterate(u_phys, state, sigma=sigma, fused=fused,
                                        overlap=overlap)
            if prev is not None:
                # lagged check: iteration i is already issued
                if tr.enabled:
                    with tr.span("cg.reduce", it=i - 1):
                        rs_host = prev[1]()
                else:
                    rs_host = prev[1]()
                residuals.append((rs_host / b_rs) ** 0.5)
                if rs_host <= stop2:
                    return CGResult(x_p=prev[0], iterations=i - 1, residuals=residuals,
                                    converged=True, wall_s=time.perf_counter() - t0)
                check(rs_host, prev[0], i - 1)
            prev = (state["x"], _fetch_later(state["rs"]))
        rs_host = prev[1]()
        residuals.append((rs_host / b_rs) ** 0.5)
        if rs_host <= stop2:
            return CGResult(x_p=prev[0], iterations=max_iters, residuals=residuals,
                            converged=True, wall_s=time.perf_counter() - t0)
        check(rs_host, prev[0], max_iters)
        raise CGMaxItersError(max_iters, (rs_host / b_rs) ** 0.5, tol, partial(max_iters))

    # -- placement policies ----------------------------------------------------

    def init_data(self) -> tuple[torch.Tensor, torch.Tensor, float, float]:
        """Build the benchmark lattice under the plan's placement policy.

        Returns:
            ``(a_phys, b_planar, init_seconds, scatter_seconds)`` — the
            physical A lattice on the plan's device, the planar B (2, 36),
            seconds of initialization, and the host-to-device copy seconds
            (``host_scatter`` only; 0.0 otherwise).

        On several slabs the ``sharded`` policy goes through
        :func:`first_touch_init`: each of this process's slabs is built
        host-locally and copied into its own range, never the whole lattice
        at once; on ranks A holds this rank's ``site_range`` only.  On
        ranks ``host_scatter`` builds the whole lattice on rank 0's host,
        copies it to rank 0's card and scatters the slabs (the scatter is
        timed), and ``replicated`` builds the whole lattice on every rank.
        """

        def build(device: torch.device) -> torch.Tensor:
            a, _ = init_canonical(self.padded_sites, device)
            return self.codec.pack(a).contiguous()

        b_planar = self.codec.pack_b(init_canonical(1, self.device)[1]).contiguous()
        _synchronize(self.device)
        t0 = time.perf_counter()
        scatter_s = 0.0
        if self.cfg.placement == "host_scatter" and self.is_ranked:
            chunks = None
            if self.rank == 0:
                whole = build(torch.device("cpu"))
            t1 = time.perf_counter()
            if self.rank == 0:
                whole = whole.to(self.device)
                chunks = [self._narrow_sites(whole, lo, hi - lo) for lo, hi in self._rank_ranges()]
            a_phys = torch.empty(self.codec.phys_shape(self.local_sites),
                                 dtype=self.codec.word_dtype, device=self.device)
            torch.distributed.scatter(a_phys, chunks, src=self._global_rank(0),
                                      group=self.group)
            _synchronize(self.device)
            scatter_s = time.perf_counter() - t1
        elif self.cfg.placement == "host_scatter":
            a_host = build(torch.device("cpu"))
            t1 = time.perf_counter()
            a_phys = a_host.to(self.device)
            _synchronize(self.device)
            scatter_s = time.perf_counter() - t1
        elif self.cfg.placement == "sharded" and self.is_multi_host:
            ranges = dist_sharding.host_site_ranges(self.padded_sites, self.mesh)
            a_phys = first_touch_init(self.codec, self.local_sites,
                                      [ranges[h] for h in self.mesh.slabs], self.device,
                                      base=self.site_range[0])
            _synchronize(self.device)
        else:  # sharded on one slab, and replicated (every device holds the lattice)
            a_phys = build(self.device)
            _synchronize(self.device)
        init_s = time.perf_counter() - t0
        return a_phys, b_planar, init_s, scatter_s

    # -- views / checks --------------------------------------------------------

    def unpack(self, c_phys: torch.Tensor) -> torch.Tensor:
        """Physical C -> canonical complex, sliced to the live lattice sites;
        on ranks every rank's sites, gathered, so a check reads the same
        lattice on every rank."""
        if self._is_local(self._site_count(c_phys)):
            c_phys = torch.cat(self.gather_ranks(c_phys), dim=_SITE_DIM[self.codec.layout])
        return self.codec.unpack(c_phys, self.cfg.shape.n_sites)

    def verify(self, c_phys: torch.Tensor) -> bool:
        """su3_bench check: with A=(1,0), B=(1/3,0) every C element is (1,0);
        on ranks each rank checks its own sites and the answer is the AND
        over the ranks.

        Two-row plans check the stored rows only: the uniform lattice is not
        SU(3), so the reconstructed third row is 0 by construction.
        """
        c = self.codec.unpack(c_phys, self._live_sites(self._site_count(c_phys)))
        if self.codec.is_compressed:
            c = c[:, :, : self.codec.stored_rows, :]
        tol = verify_tolerance(
            self.cfg.dtype, self.cfg.accum_dtype, reconstruct=self.codec.is_compressed
        )
        return self.every_rank(bool(
            torch.max(torch.abs(c.real - 1.0)).item() < tol
            and torch.max(torch.abs(c.imag)).item() < tol
        ))

    def describe(self) -> str:
        """Compact plan identity for benchmark rows / logs."""
        c = self.cfg
        acc = f"+acc-{c.accum_dtype}" if c.is_mixed_precision else ""
        comp = "+two-row" if c.is_compressed else ""
        placement = c.placement
        if placement == "replicated" and self.world == 1:
            placement = "replicated(=sharded on 1 device)"
        hosts = f"x{self.n_hosts}h" if self.is_multi_host else ""
        ranks = f"/rank{self.rank}of{self.world}" if self.is_ranked else ""
        return (
            f"{self.codec.layout.value}/{c.variant}/t{c.tile}/{placement}"
            f"@{self.n_devices}dev{hosts}:{self.device}/{c.dtype}{acc}{comp}{ranks}"
        )


def build_plan(
    cfg: EngineConfig, device: MeshSpec | SlabMesh | torch.device | str | None = None
) -> ExecutionPlan:
    """THE construction site: config tuple -> ExecutionPlan.

    Args:
        cfg: the tunable tuple (layout, variant, tile, placement, dtypes, L).
        device: ``None`` (the CUDA device; raises without CUDA), an explicit
            device such as ``"cpu"`` (one slab), a
            :class:`~repro_torch.launch.mesh.MeshSpec` (its slabs on the
            CUDA device) or a resolved
            :class:`~repro_torch.launch.mesh.SlabMesh` (its slabs on its
            device, e.g. ``MeshSpec(hosts=2).resolve("cpu")``).
    """
    return ExecutionPlan(cfg, resolve_mesh(device))


class BatchedLatticeRunner:
    """Serve B independent lattices through one plan, whole lattices per
    device.

    The "many users" scenario: each request carries its own (A, B) lattice
    pair.  The batch splits over the plan's mesh as the reference shards
    its batch axis (:meth:`ExecutionPlan.lattice_batch_blocks`: whole
    lattices per device, host-major, so one host's requests stay on that
    host's devices), and each block runs in ONE launch of the multiply
    kernel on its device, with no per-request wiring.  A batch that does
    not divide the device count is padded with zero lattices, and the
    padding is sliced off.

    The physical batch (``pack_batch``, ``run``) is one tensor when the
    process's blocks share a device and a list of tensors, one per device,
    when they do not.  On a ranked mesh a rank packs and computes only its
    own lattices (first touch per rank): ``run`` takes and returns the
    rank's blocks, and ``multiply`` returns the whole batch on every rank
    through one all-gather in rank order.

    Args:
        cfg: the plan tuple every lattice of the batch shares.
        mesh: what the reference's runner takes — a
            :class:`~repro_torch.launch.mesh.MeshSpec` (resolved on the
            card, ranked under a running process group), a resolved
            :class:`~repro_torch.launch.mesh.SlabMesh`, or ``None`` (the
            card; raises without CUDA) — or a device such as ``"cpu"`` (one
            block).
    """

    def __init__(self, cfg: EngineConfig,
                 mesh: MeshSpec | SlabMesh | torch.device | str | None = None):
        self.plan = build_plan(cfg, mesh)
        self.cfg = cfg
        self.mesh = self.plan.mesh
        self.device = self.plan.device
        self.n_devices = self.plan.n_devices
        self._steps: dict[int, Step] = {}
        self._plans: dict[torch.device, ExecutionPlan] = {}

    def padded(self, bsz: int) -> int:
        """``bsz`` padded to a multiple of ``n_devices``."""
        return bsz + (-bsz) % self.n_devices

    def blocks(self, bsz: int) -> list[dist_sharding.BatchBlock]:
        """This process's blocks of a batch of ``bsz`` lattices (padded)."""
        return self.plan.lattice_batch_blocks(self.padded(bsz))

    def plan_on(self, device: torch.device | str) -> ExecutionPlan:
        """The runner's plan on ``device``, one of its mesh's devices (the
        same site padding), built once: per-lattice work that keeps tables
        on its device (the stencil's gather) runs through it."""
        dev = torch.device(device)
        if dev == self.device:
            return self.plan
        if dev not in self._plans:
            self._plans[dev] = build_plan(self.cfg, dataclasses.replace(self.mesh, device=dev))
        return self._plans[dev]

    def _batched_step(self, k: int) -> Step:
        if k not in self._steps:
            raw = make_raw_step(self.plan.codec, self.plan.kernel, tile=self.cfg.tile,
                                k_iters=k)
            if self.plan.kernel.form == registry.PLANAR:
                self._steps[k] = raw  # the kernel takes the batch axis itself
            else:  # a plain torch variant: one call per lattice, no kernel
                def per_lattice(a, b, out=None):
                    c = torch.stack([raw(x, y) for x, y in zip(a, b)])
                    return c if out is None else out.copy_(c)

                self._steps[k] = per_lattice
        return self._steps[k]

    def _pack_parts(self, x: torch.Tensor, pack: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor | list[torch.Tensor]:
        """``pack`` each lattice of this process's blocks of the batch ``x``
        (zero lattices past its end) on the block's device, one tensor per
        device run."""
        x = torch.as_tensor(x)
        parts = []
        for part in dist_sharding.device_parts(self.blocks(x.shape[0])):
            lo, hi, dev = part[0].lo, part[-1].hi, part[0].device
            y = x[lo:min(hi, x.shape[0])].to(dev)
            if y.shape[0] < hi - lo:
                y = torch.cat([y, y.new_zeros((hi - lo - y.shape[0],) + tuple(y.shape[1:]))])
            parts.append(torch.stack([pack(z) for z in y]).contiguous())
        return parts[0] if len(parts) == 1 else parts

    def pack_batch(self, a: torch.Tensor) -> torch.Tensor | list[torch.Tensor]:
        """Canonical (B, n_sites, 4, 3, 3) complex -> this process's blocks
        of the batch in physical form: the batch padded with zero lattices
        to a multiple of ``n_devices``, each lattice zero-padded to the
        plan's site capacity, each block on its device.

        Raises:
            ValueError: when a lattice carries more sites than the plan holds.
        """
        if a.shape[1] > self.plan.padded_sites:
            raise ValueError(
                f"batch carries {a.shape[1]} sites > plan capacity "
                f"{self.plan.padded_sites} (L={self.cfg.L}, tile={self.cfg.tile})"
            )
        pad = self.plan.padded_sites - a.shape[1]

        def pack(x: torch.Tensor) -> torch.Tensor:
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return self.plan.codec.pack(x)

        return self._pack_parts(a, pack)

    def pack_lattice(self, a: torch.Tensor, device: torch.device | str) -> torch.Tensor:
        """One canonical lattice (n_sites, 4, 3, 3) in physical form on
        ``device``, zero-padded to the plan's site capacity."""
        pad = self.plan.padded_sites - a.shape[0]
        a = torch.as_tensor(a).to(device)
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return self.plan.codec.pack(a).contiguous()

    def pack_b_batch(self, b: torch.Tensor) -> torch.Tensor | list[torch.Tensor]:
        """Canonical (B, 4, 3, 3) complex -> planar (B', 2, 36) words, in
        :meth:`pack_batch`'s blocks."""
        return self._pack_parts(b, self.plan.codec.pack_b)

    def pack_vec_batch(self, v: torch.Tensor) -> torch.Tensor | list[torch.Tensor]:
        """Canonical (B, n_sites, 3) vector fields -> planar (B', 2, 3,
        padded_sites), in :meth:`pack_batch`'s blocks."""
        return self._pack_parts(v, lambda x: self.plan.codec.pack_vec(x, self.plan.padded_sites))

    def unpack_batch(self, c_phys: torch.Tensor | list[torch.Tensor],
                     n_sites: int | None = None) -> torch.Tensor:
        """Batched physical -> canonical complex (B, n_sites, 4, 3, 3), a new
        tensor (never a view of ``c_phys``); a batch on several devices is
        unpacked there and joined on the runner's device."""
        n = n_sites if n_sites is not None else self.cfg.shape.n_sites
        return torch.stack([self.plan.codec.unpack(x, n).to(self.device)
                            for part in _as_parts(c_phys) for x in part])

    def run(self, a_batch: torch.Tensor | list[torch.Tensor],
            b_batch: torch.Tensor | list[torch.Tensor], k: int = 1
            ) -> torch.Tensor | list[torch.Tensor]:
        """Batched physical A x planar B (B, 2, 36) -> physical C batch:
        one kernel launch per block, chaining ``k`` multiplies per lattice.

        Without a group a tensor of any batch size is padded to the device
        count and the padding sliced off, as the reference's ``run`` does;
        a list carries whole blocks, one tensor per device (``pack_batch``'s
        form).  On ranks the arguments are this rank's blocks.
        """
        step = self._batched_step(k)
        if isinstance(a_batch, torch.Tensor) and not self.plan.is_ranked:
            bsz = a_batch.shape[0]
            pad = self.padded(bsz) - bsz
            if pad:
                a_batch = torch.cat([a_batch, a_batch.new_zeros((pad,) + a_batch.shape[1:])])
                b_batch = torch.cat([b_batch, b_batch.new_zeros((pad,) + b_batch.shape[1:])])
            c = _launch_blocks(self.plan.lattice_batch_blocks(bsz + pad), step, False,
                               a_batch, b_batch)
            return c[:bsz] if pad else c
        held = sum(x.shape[0] for x in _as_parts(a_batch))
        blocks = self.plan.lattice_batch_blocks(held * self.plan.world)
        return _launch_blocks(blocks, step, False, a_batch, b_batch)

    def multiply(self, a: torch.Tensor, b: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Canonical batched entry: a (B, S, 4, 3, 3), b (B, 4, 3, 3)
        complex -> the whole batch's C (B, S, 4, 3, 3) on the runner's
        device (on every rank: one all-gather of the ranks' blocks)."""
        bsz, n_sites = a.shape[0], a.shape[1]
        c = self.unpack_batch(self.run(self.pack_batch(a), self.pack_b_batch(b), k=k), n_sites)
        if self.plan.is_ranked:
            c = torch.cat(self.plan.gather_ranks(c))
        return c[:bsz] if c.shape[0] != bsz else c


def _tensor_from_numpy(arr: np.ndarray, dtype: str, what: str) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if dtype == "bfloat16":
        # numpy carries bf16 as ml_dtypes.bfloat16, which torch.from_numpy
        # refuses: move the bits through a uint16 view.
        if arr.dtype.name != "bfloat16":
            raise ValueError(f"{what}: expected bfloat16 words, got {arr.dtype}")
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype != np.dtype(dtype):
        raise ValueError(f"{what}: expected {dtype} words, got {arr.dtype}")
    return torch.from_numpy(arr.copy())


def state_from_reference(
    plan: ExecutionPlan, a_phys: np.ndarray, b_planar: np.ndarray
) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry a reference plan's lattice into this plan.

    Args:
        plan: the port's plan for the same EngineConfig.
        a_phys: the reference plan's physical A, as a numpy array.
        b_planar: the reference plan's planar B (2, 36), as a numpy array.

    Returns:
        ``(a_phys, b_planar)`` as tensors on the plan's device.

    Raises:
        ValueError: when a shape or word dtype does not match this plan's
            codec.
    """
    want = plan.codec.phys_shape(plan.padded_sites)
    if tuple(a_phys.shape) != want:
        raise ValueError(f"a_phys: expected shape {want}, got {tuple(a_phys.shape)}")
    if tuple(b_planar.shape) != (2, layouts.PLANAR_ROWS):
        raise ValueError(f"b_planar: expected shape (2, 36), got {tuple(b_planar.shape)}")
    a = _tensor_from_numpy(a_phys, plan.cfg.dtype, "a_phys")
    b = _tensor_from_numpy(b_planar, plan.cfg.dtype, "b_planar")
    return a.to(plan.device), b.to(plan.device)


def vectors_from_reference(
    plan: ExecutionPlan, *planar_arrays: np.ndarray
) -> tuple[torch.Tensor, ...]:
    """Carry a reference plan's planar vector fields into this plan.

    Args:
        plan: the port's plan for the same EngineConfig.
        planar_arrays: ``(2, 3, padded_sites)`` numpy arrays from the
            reference plan (``pack_rhs`` / ``codec.pack_vec`` output), in the
            plan's word dtype (bf16 as ``ml_dtypes.bfloat16``).

    Returns:
        One tensor on the plan's device per array, in order.

    Raises:
        ValueError: when a shape or word dtype does not match this plan.
    """
    want = (2, layouts.SU3, plan.padded_sites)
    out = []
    for i, arr in enumerate(planar_arrays):
        if tuple(arr.shape) != want:
            raise ValueError(f"vector {i}: expected shape {want}, got {tuple(arr.shape)}")
        out.append(_tensor_from_numpy(arr, plan.cfg.dtype, f"vector {i}").to(plan.device))
    return tuple(out)
