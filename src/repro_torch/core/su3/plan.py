"""ExecutionPlan: the one dispatch path for SU3 work (port of
``repro.core.su3.plan``: the multiply, the stencil and the CG solver on one
slab).

    EngineConfig (L, dtype, layout, variant, tile, placement)
          │  build_plan(cfg, device) — single construction site
          ▼
    ExecutionPlan
      codec         LayoutCodec   pack / unpack / physical shapes
      kernel        KernelEntry   unified registry (torch variants + CUDA kernels)
      step          (a_phys, b_planar) -> c_phys, one launch, fresh output
      fused(k)      one launch chaining k multiplies
      fused_batched_step(slots, max_k)
                    one megakernel launch over a slot table, per-slot depths
      stencil_step  gather the 8 neighbours (index_select), one stencil launch
      cg_solve      CG on sigma I + S: per iteration two gathers, one fused
                    stencil+axpy launch, the shared epilogue

The plan lives on one device, ``"cuda"`` unless the caller asks for
``"cpu"``.  Placement on one card:

  * ``sharded``      — the lattice is built directly on the device;
  * ``host_scatter`` — built on the CPU, then copied with ``.to(device)``;
                       the copy is timed as ``scatter_s``;
  * ``replicated``   — the same as ``sharded`` on one device (``describe``
                       says so).

The stencil's neighbour gather runs outside the kernel, as in the
reference: ``torch.index_select`` fills a preallocated direction-major
(8, 2, 3, S) block per vector field.  CG keeps every scalar on the device
(beta and sigma travel in a (1, 2) tensor) and fetches one residual per
iteration, one iteration late.

:class:`BatchedLatticeRunner` serves B independent lattices through one
plan: one launch of the multiply kernel over the whole batch (the kernel's
batch axis stands in for the reference's ``vmap``).

Not here yet: meshes and multi-host first-touch init, the multi-slab stencil
and CG schedules (exchange / interior / boundary, the depth-2 ring), and the
plan's tracer and halo-fault hooks.  On one card there is one slab and one
device, and the reference's single-host paths are the ones ported.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.su3 import layouts, registry
from repro_torch.core.su3 import variants as _variants  # noqa: F401  (registers torch variants)
from repro_torch.core.su3.layouts import Layout, LatticeShape, LayoutCodec
from repro_torch.distributed import sharding as dist_sharding
from repro_torch.kernels import ops as _kops  # noqa: F401  (registers the CUDA kernels)

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
    ``alias`` lets a planar kernel write C into A's storage.
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

        def raw_step(a_phys: torch.Tensor, b_p: torch.Tensor) -> torch.Tensor:
            return kernel.fn(a_phys, b_p, **kw)

    else:  # canonical complex kernel wrapped by the codec

        def raw_step(a_phys: torch.Tensor, b_p: torch.Tensor) -> torch.Tensor:
            b = codec.unpack_b(b_p)
            phys = a_phys
            for _ in range(k_iters):
                phys = codec.pack(kernel.fn(codec.unpack(phys), b)).contiguous()
            return phys

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
        a_batch: torch.Tensor, b_batch: torch.Tensor, slot_k: torch.Tensor
    ) -> torch.Tensor:
        return kernel.fn(a_batch, b_batch, slot_k, **kw)

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


class ExecutionPlan:
    """Execution of one EngineConfig tuple on one device.

    Construct via :func:`build_plan` — the single construction site for every
    layout x variant x placement combination.

    Attributes:
        codec: canonical (S, 4, 3, 3) complex <-> physical layout conversions.
        kernel: the resolved :class:`~repro_torch.core.su3.registry.KernelEntry`.
        device: the plan's device.
        padded_sites: site count padded to a whole number of tiles.
        step: ``(a_phys, b_planar) -> c_phys`` — one launch into a fresh
            output; the input is left intact (``SU3Engine.run`` reuses it).
    """

    n_devices = 1

    def __init__(self, cfg: EngineConfig, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
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
        # Lattice padded to a whole number of tiles (the reference pads to
        # n_devices * tile; here n_devices is 1).
        n = cfg.shape.n_sites
        chunk = self.n_devices * cfg.tile
        self.padded_sites = ((n + chunk - 1) // chunk) * chunk
        self.step = make_raw_step(self.codec, self.kernel, tile=cfg.tile)
        self._fused_steps: dict[int, Step] = {}
        self._batched_steps: dict[tuple[int, int, bool], Callable[..., torch.Tensor]] = {}
        self._stencil_steps: dict[tuple[bool, int], Step] = {}
        self._stencil_tables: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self._nbr_bufs: dict[str, torch.Tensor] = {}
        self._cg_help: dict[str, Callable[..., Any]] | None = None
        self._cg_applies: dict[tuple[bool, bool], Callable[..., Any]] = {}

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
        """ONE megakernel launch advancing a whole slot table.

        ``fused_batched_step(slots, max_k)(a_batch, b_batch, slot_k)`` equals
        applying ``step`` ``slot_k[s]`` times to slot ``s`` independently —
        bit for bit, since both kernels run one chain body — but every
        slot's chain runs in one launch over (slots x sites), so a serving
        iteration costs one launch however many chains are in flight.
        Per-slot depths are data (an int32 tensor on the plan's device, read
        by the kernel), clamped to ``max_k``; depth 0 passes a slot through.

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
            self._batched_steps[key] = make_raw_batched_step(
                self.codec, kernel, tile=self.cfg.tile, max_k=max_k, alias=bool(alias)
            )
        return self._batched_steps[key]

    # -- nearest-neighbour stencil (Dslash-style) -------------------------------

    def stencil_halo(self, depth: int = 1) -> dist_sharding.HaloSpec:
        """Halo spec of the stencil's vector-field exchange: 6 words per site
        at the plan's storage width; ``depth=2`` prices the exchange that
        feeds two applications.  One slab on one card: nothing is sent."""
        return dist_sharding.HaloSpec(
            L=self.cfg.L,
            n_shards=1,
            word_bytes=self.cfg.word_bytes,
            words_per_site=dist_sharding.VECTOR_WORDS_PER_SITE,
            depth=depth,
        )

    def _stencil_geometry(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The neighbour tables of one slab as int64 tensors on the plan's
        device, built once per plan."""
        if self._stencil_tables is None:
            tables = stencil_neighbor_tables(self.cfg.L, self.padded_sites, 1)
            self._stencil_tables = tuple(
                torch.from_numpy(t.astype(np.int64)).to(self.device) for t in tables
            )
        return self._stencil_tables

    def gather_neighbors(
        self, v_p: torch.Tensor, slot: str = "v", overlap: bool = False
    ) -> torch.Tensor:
        """Fill the plan's (8, 2, 3, padded_sites) block ``slot`` with the 8
        shifted copies of ``v_p`` (2, 3, padded_sites), direction-major, and
        return it: one ``index_select`` per direction, straight into the
        block.  The block is reused by the next gather into the same slot
        (stream order makes that safe for the kernel that reads it).
        ``overlap`` takes the slab-local table, which on one slab is the
        periodic table."""
        glob, local, _bidx = self._stencil_geometry()
        table = local if overlap else glob
        buf = self._nbr_bufs.get(slot)
        if buf is None:
            buf = torch.empty((8, 2, layouts.SU3, self.padded_sites),
                              dtype=self.codec.word_dtype, device=self.device)
            self._nbr_bufs[slot] = buf
        for d in range(8):
            torch.index_select(v_p, 2, table[d], out=buf[d])
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

    def raw_stencil_reference(self, overlap: bool = False) -> Step:
        """``(u_phys, v_p) -> out_p``: gather all 8 neighbour fields, then ONE
        kernel pass over every site (the physical links are read in place,
        AoSoA included)."""
        kernel, kw = self._stencil_kernel_kwargs()

        def reference(u_phys: torch.Tensor, v_p: torch.Tensor) -> torch.Tensor:
            return kernel.fn(u_phys, self.gather_neighbors(v_p, "v", overlap), **kw)

        return reference

    def stencil_reference_step(self) -> Step:
        """The non-overlapped stencil step (the serial path)."""
        return self.stencil_step(overlap=False)

    def stencil_step(self, overlap: bool | None = None, depth: int = 1) -> Step:
        """The stencil dispatch path: ``step(u_phys, v_p) -> out_p``.

        ``u_phys`` is the plan's physical gauge lattice, ``v_p`` the planar
        (2, 3, padded_sites) vector field (``codec.pack_vec``); the result
        is the planar output field.  ``depth`` applications run per call
        (depth=2 equals two depth-1 steps).

        overlap=False is the serial path: the periodic gather, then the
        kernel over all sites.  overlap=True is the reference's split
        schedule; on one slab it has no boundary, so it is the single
        slab-local pass (the reference's ``local_only`` path), which gives
        the serial path's bits.  ``None`` means False: one card is one host.
        """
        if depth not in (1, 2):
            raise ValueError(f"stencil exchange depth must be 1 or 2, got {depth}")
        key = (bool(overlap), depth)
        if key not in self._stencil_steps:
            one = self.raw_stencil_reference(overlap=bool(overlap))
            if depth == 1:
                self._stencil_steps[key] = one
            else:
                self._stencil_steps[key] = lambda u_phys, v_p: one(u_phys, one(u_phys, v_p))
        return self._stencil_steps[key]

    def init_stencil_data(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The canonical stencil inputs ``(u_phys, v_p)`` under the plan's
        placement: U entries (1, 0), v entries (1/24, 0), so every output
        component of the stencil is exactly (1, 0)."""
        a_phys, _b, _init_s, _scatter_s = self.init_data()
        _, v = init_stencil_canonical(self.cfg.shape.n_sites, self.device)
        return a_phys, self.codec.pack_vec(v, self.padded_sites)

    def unpack_vec(self, out_p: torch.Tensor) -> torch.Tensor:
        """Planar stencil output -> canonical complex (n_sites, 3)."""
        return self.codec.unpack_vec(out_p, self.cfg.shape.n_sites)

    def pack_gauge(self, u: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Canonical complex ``(n_sites, 4, 3, 3)`` gauge field (tensor or
        numpy) -> the physical layout on the plan's device, zero-padded to
        ``padded_sites``.  Padding sites self-neighbour in the tables and
        carry zero links, so they add nothing to any stencil or CG output."""
        u = torch.as_tensor(u).to(self.device)
        n = u.shape[0]
        if n < self.padded_sites:
            pad = torch.zeros((self.padded_sites - n,) + tuple(u.shape[1:]), dtype=u.dtype,
                              device=self.device)
            u = torch.cat([u, pad])
        return self.codec.pack(u).contiguous()

    def pack_rhs(self, b: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Canonical complex ``(n_sites, 3)`` vector field (tensor or numpy)
        -> planar ``(2, 3, padded_sites)`` on the plan's device (zero padding
        keeps every CG reduction over the padded array exact)."""
        return self.codec.pack_vec(torch.as_tensor(b).to(self.device), self.padded_sites)

    def verify_stencil(self, out_p: torch.Tensor) -> bool:
        """Fixed-point check for :meth:`init_stencil_data` inputs: every
        output component is (1, 0) within the storage dtype's tolerance.

        Two-row plans see another fixed point: the uniform lattice is not
        SU(3), so the rebuilt row 2 is ``conj(r0 x r1) = 0`` and the sum is
        ``4 (U + U^T) v = (5/6, 5/6, 1/3)`` per component, computed here
        from the rebuilt link.
        """
        c = self.unpack_vec(out_p)
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
        return bool(
            torch.max(torch.abs(c.real - expected)).item() < tol
            and torch.max(torch.abs(c.imag)).item() < tol
        )

    # -- conjugate-gradient solver (fused stencil+axpy iteration) ---------------

    def _cg_helpers(self) -> dict[str, Callable[..., Any]]:
        """The scalar and elementwise CG pieces, plain torch, shared verbatim
        by the fused and composed paths: alpha, beta, the x/r updates and
        both reductions are the same calls on both, so fused and composed
        iterates match bit for bit at f32.  Every product and sum is its own
        tensor op (no ``add(alpha=)``, ``addcmul`` or ``lerp``), so nothing
        contracts into an FMA that the fused kernel does not do."""
        if self._cg_help is not None:
            return self._cg_help
        f32, dev = torch.float32, self.device

        def scalar(x: torch.Tensor | float) -> torch.Tensor:
            if isinstance(x, torch.Tensor):
                return x.to(f32)
            return torch.full((), float(x), dtype=f32, device=dev)  # a fill, no copy

        def rr(v: torch.Tensor) -> torch.Tensor:
            v = v.to(f32)
            return torch.sum(v * v)

        def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return torch.sum(a.to(f32) * b.to(f32))

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
        shift runs in the shared epilogue.  fused=False: the shared axpy,
        then ``stencil_step(overlap)``, then the same epilogue.  On one slab
        ``overlap`` only picks the slab-local table, which is the periodic
        one.
        """
        key = (bool(fused), bool(overlap))
        if key in self._cg_applies:
            return self._cg_applies[key]
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

        def fused_whole(u_phys, r_p, p_p, coefs):
            r_nbr = self.gather_neighbors(r_p, "r", overlap)
            p_nbr = self.gather_neighbors(p_p, "p", overlap)
            p_new, s = kernel.fn(u_phys, r_nbr, p_nbr, r_p, p_p, coefs, **kw)
            return p_new, h["shift"](p_new, coefs[0, 1], s)

        self._cg_applies[key] = fused_whole
        return fused_whole

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
        caller decides when to read ``state["rs"]``."""
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
        runs past convergence.

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
            state = self.cg_iterate(u_phys, state, sigma=sigma, fused=fused, overlap=overlap)
            if prev is not None:
                # lagged check: iteration i is already issued
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
        """

        def build(device: torch.device) -> torch.Tensor:
            a, _ = init_canonical(self.padded_sites, device)
            return self.codec.pack(a).contiguous()

        b_planar = self.codec.pack_b(init_canonical(1, self.device)[1]).contiguous()
        _synchronize(self.device)
        t0 = time.perf_counter()
        scatter_s = 0.0
        if self.cfg.placement == "host_scatter":
            a_host = build(torch.device("cpu"))
            t1 = time.perf_counter()
            a_phys = a_host.to(self.device)
            _synchronize(self.device)
            scatter_s = time.perf_counter() - t1
        else:  # sharded, and replicated (one device holds the whole lattice)
            a_phys = build(self.device)
            _synchronize(self.device)
        init_s = time.perf_counter() - t0
        return a_phys, b_planar, init_s, scatter_s

    # -- views / checks --------------------------------------------------------

    def unpack(self, c_phys: torch.Tensor) -> torch.Tensor:
        """Physical C -> canonical complex, sliced to the live lattice sites."""
        return self.codec.unpack(c_phys, self.cfg.shape.n_sites)

    def verify(self, c_phys: torch.Tensor) -> bool:
        """su3_bench check: with A=(1,0), B=(1/3,0) every C element is (1,0).

        Two-row plans check the stored rows only: the uniform lattice is not
        SU(3), so the reconstructed third row is 0 by construction.
        """
        c = self.unpack(c_phys)
        if self.codec.is_compressed:
            c = c[:, :, : self.codec.stored_rows, :]
        tol = verify_tolerance(
            self.cfg.dtype, self.cfg.accum_dtype, reconstruct=self.codec.is_compressed
        )
        return bool(
            torch.max(torch.abs(c.real - 1.0)).item() < tol
            and torch.max(torch.abs(c.imag)).item() < tol
        )

    def describe(self) -> str:
        """Compact plan identity for benchmark rows / logs."""
        c = self.cfg
        acc = f"+acc-{c.accum_dtype}" if c.is_mixed_precision else ""
        comp = "+two-row" if c.is_compressed else ""
        placement = c.placement
        if placement == "replicated":
            placement = "replicated(=sharded on 1 device)"
        return (
            f"{self.codec.layout.value}/{c.variant}/t{c.tile}/{placement}"
            f"@{self.n_devices}dev:{self.device}/{c.dtype}{acc}{comp}"
        )


def build_plan(cfg: EngineConfig, device: torch.device | str | None = None) -> ExecutionPlan:
    """THE construction site: config tuple -> ExecutionPlan.

    Args:
        cfg: the tunable tuple (layout, variant, tile, placement, dtypes, L).
        device: ``None`` (the CUDA device; raises without CUDA) or an
            explicit device such as ``"cpu"``.
    """
    return ExecutionPlan(cfg, resolve_device(device))


class BatchedLatticeRunner:
    """Serve B independent lattices through one plan step.

    The "many users" scenario: each request carries its own (A, B) lattice
    pair, and the whole batch runs through the plan's kernel in ONE launch
    (the multiply kernel's batch axis, one B per lattice), with no
    per-request wiring.  The reference shards the batch over a mesh and pads
    it to a device multiple; on one card ``n_devices`` is 1, so nothing is
    padded.

    Args:
        cfg: the plan tuple every lattice of the batch shares.
        device: ``None`` (the CUDA device; raises without CUDA) or an
            explicit device such as ``"cpu"``.
    """

    n_devices = 1

    def __init__(self, cfg: EngineConfig, device: torch.device | str | None = None):
        self.plan = build_plan(cfg, device)
        self.cfg = cfg
        self.device = self.plan.device
        self._steps: dict[int, Step] = {}

    def _batched_step(self, k: int) -> Step:
        if k not in self._steps:
            raw = make_raw_step(self.plan.codec, self.plan.kernel, tile=self.cfg.tile,
                                k_iters=k)
            if self.plan.kernel.form == registry.PLANAR:
                self._steps[k] = raw  # the kernel takes the batch axis itself
            else:  # a plain torch variant: one call per lattice, no kernel
                self._steps[k] = lambda a, b: torch.stack([raw(x, y) for x, y in zip(a, b)])
        return self._steps[k]

    def pack_batch(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical (B, n_sites, 4, 3, 3) complex -> batched physical form,
        each lattice zero-padded to the plan's site capacity.

        Raises:
            ValueError: when a lattice carries more sites than the plan holds.
        """
        if a.shape[1] > self.plan.padded_sites:
            raise ValueError(
                f"batch carries {a.shape[1]} sites > plan capacity "
                f"{self.plan.padded_sites} (L={self.cfg.L}, tile={self.cfg.tile})"
            )
        a = torch.as_tensor(a).to(self.device)
        pad = self.plan.padded_sites - a.shape[1]
        if pad:
            a = torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], dim=1)
        return torch.stack([self.plan.codec.pack(x) for x in a]).contiguous()

    def pack_b_batch(self, b: torch.Tensor) -> torch.Tensor:
        """Canonical (B, 4, 3, 3) complex -> planar (B, 2, 36) words."""
        b = torch.as_tensor(b).to(self.device)
        return torch.stack([self.plan.codec.pack_b(x) for x in b]).contiguous()

    def unpack_batch(self, c_phys: torch.Tensor, n_sites: int | None = None) -> torch.Tensor:
        """Batched physical -> canonical complex (B, n_sites, 4, 3, 3), a new
        tensor (never a view of ``c_phys``)."""
        n = n_sites if n_sites is not None else self.cfg.shape.n_sites
        return torch.stack([self.plan.codec.unpack(x, n) for x in c_phys])

    def run(self, a_batch: torch.Tensor, b_batch: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Batched physical (B, ...) x planar B (B, 2, 36) -> physical C
        batch: one kernel launch chaining ``k`` multiplies per lattice."""
        return self._batched_step(k)(a_batch, b_batch)

    def multiply(self, a: torch.Tensor, b: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Canonical batched entry: a (B, S, 4, 3, 3), b (B, 4, 3, 3) complex."""
        n_sites = a.shape[1]
        c_phys = self.run(self.pack_batch(a), self.pack_b_batch(b), k=k)
        return self.unpack_batch(c_phys, n_sites)


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
