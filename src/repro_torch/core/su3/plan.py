"""ExecutionPlan: the one dispatch path for the SU3 multiply (port of the
multiply half of ``repro.core.su3.plan``).

    EngineConfig (L, dtype, layout, variant, tile, placement)
          │  build_plan(cfg, device) — single construction site
          ▼
    ExecutionPlan
      codec     LayoutCodec   pack / unpack / physical shapes
      kernel    KernelEntry   unified registry (torch variants + CUDA kernel)
      step      (a_phys, b_planar) -> c_phys, one launch, fresh output
      fused(k)  one launch chaining k multiplies

The plan lives on one device, ``"cuda"`` unless the caller asks for
``"cpu"``.  Placement on one card:

  * ``sharded``      — the lattice is built directly on the device;
  * ``host_scatter`` — built on the CPU, then copied with ``.to(device)``;
                       the copy is timed as ``scatter_s``;
  * ``replicated``   — the same as ``sharded`` on one device (``describe``
                       says so).

Not here yet: meshes and multi-host first-touch init, the stencil, CG, the
slot-batched megakernel step and ``BatchedLatticeRunner``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.su3 import layouts, registry
from repro_torch.core.su3 import variants as _variants  # noqa: F401  (registers torch variants)
from repro_torch.core.su3.layouts import Layout, LatticeShape, LayoutCodec
from repro_torch.kernels import ops as _kops  # noqa: F401  (registers the CUDA kernel)

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
