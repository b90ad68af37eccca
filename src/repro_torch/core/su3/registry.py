"""Unified SU3 kernel registry (PyTorch port of ``repro.core.su3.registry``).

One namespace for every SU3 kernel, with the metadata a plan validates and
wires a kernel by:

  ``form``
      ``"canonical"`` — fn(a, b) on canonical complex tensors
      (a: (S, 4, 3, 3), b: (4, 3, 3)); the plan wraps it with the layout
      codec's unpack/pack.
      ``"planar"`` — fn(a_phys, b_p, *, tile, k_iters, alias, accum_dtype?,
      compressed?) on the PHYSICAL planar layout — SoA (2, rows, S) or AoSoA
      (tiles, 2, rows, tile) — with b_p: (2, 36).  The CUDA kernel reads both
      layouts in place through their strides.
      ``"stencil"`` — fn(u_phys, v_nbr, *, tile, accum_dtype?, compressed?):
      the nearest-neighbour stencil over gathered neighbours (8, 2, 3, S).
      ``"stencil_axpy"`` — fn(u_phys, r_nbr, p_nbr, r, p, coefs, ...): the
      fused CG body.  Both dispatch through ``ExecutionPlan.stencil_step`` /
      ``cg_solve``.
      ``"batched"`` — fn(a_batch, b_batch, slot_k, *, tile, max_k, alias,
      accum_dtype?, compressed?): the slot-batched megakernel over a
      physical slot table (slots, ...) with per-slot B (slots, 2, 36) and
      per-slot chain depths; dispatches through
      ``ExecutionPlan.fused_batched_step``.
  ``layouts``
      which physical layouts the kernel can be planned with.
  ``backends``
      ``"torch"`` (plain PyTorch) | ``"cuda"`` (a hand-written CUDA kernel).
  ``supports_fused`` / ``supports_accum`` / ``supports_compressed``
      fn accepts ``k_iters`` (chained multiplies in one launch), an
      ``accum_dtype`` wider than its storage words, and two-row gauge blocks.
      Canonical kernels get accumulation and compression for free: the codec
      unpacks to complex64 (rebuilding row 2) before they run.

``REFERENCE_NAMES`` maps the reference's variant names onto the port's, so
the same ``EngineConfig`` fields build a plan in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from repro_torch.core.su3.layouts import Layout

CANONICAL = "canonical"
PLANAR = "planar"
BATCHED = "batched"
STENCIL = "stencil"
STENCIL_AXPY = "stencil_axpy"

# reference variant name -> port variant name (names not listed are equal)
REFERENCE_NAMES = {
    "pallas": "cuda",
    "pallas_megakernel": "cuda_megakernel",
    "pallas_stencil": "cuda_stencil",
    "pallas_cg": "cuda_cg",
}


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One registered SU3 kernel plus the metadata a plan validates against.

    Attributes:
        name: registry key (``EngineConfig.variant``).
        fn: the kernel callable (signature per ``form``, module docstring).
        layouts: physical layouts the kernel can be planned with.
        backends: ``"torch"`` / ``"cuda"`` — what runs the body.
        form: one of the module constants (``"canonical"``, ``"planar"``,
            ``"stencil"``, ...).
        supports_fused: fn accepts ``k_iters``.
        supports_accum: fn accepts ``accum_dtype`` (planar mixed precision).
        supports_compressed: fn accepts ``compressed`` (two-row gauge).
    """

    name: str
    fn: Callable
    layouts: tuple[Layout, ...]
    backends: tuple[str, ...]
    form: str = CANONICAL
    supports_fused: bool = False
    supports_accum: bool = False
    supports_compressed: bool = False

    def supports_layout(self, layout: Layout) -> bool:
        """Whether this kernel can be planned with ``layout`` (accepts the
        enum or its string value)."""
        return Layout(layout) in self.layouts

    def supports_accum_dtype(self) -> bool:
        """Planar kernels must opt in; canonical kernels always accumulate
        in float32 (the codec unpacks to complex64)."""
        return self.supports_accum or self.form == CANONICAL

    def supports_compression(self) -> bool:
        """Planar kernels must opt in; canonical kernels see the codec's
        reconstructed row 2."""
        return self.supports_compressed or self.form == CANONICAL


_KERNELS: dict[str, KernelEntry] = {}


def register_kernel(
    name: str,
    *,
    layouts: Iterable[Layout] = (Layout.AOS, Layout.SOA, Layout.AOSOA),
    backends: Iterable[str] = ("torch",),
    form: str = CANONICAL,
    supports_fused: bool = False,
    supports_accum: bool = False,
    supports_compressed: bool = False,
) -> Callable[[Callable], Callable]:
    """Decorator registering ``fn`` as kernel ``name``; returns fn unchanged.

    Raises:
        ValueError: on an unknown ``form``.
    """
    if form not in (CANONICAL, PLANAR, BATCHED, STENCIL, STENCIL_AXPY):
        raise ValueError(f"unknown kernel form {form!r}")

    def deco(fn: Callable) -> Callable:
        _KERNELS[name] = KernelEntry(
            name=name,
            fn=fn,
            layouts=tuple(Layout(l) for l in layouts),
            backends=tuple(backends),
            form=form,
            supports_fused=supports_fused,
            supports_accum=supports_accum,
            supports_compressed=supports_compressed,
        )
        return fn

    return deco


def get_kernel(name: str) -> KernelEntry:
    """The registered entry for ``name`` (a port name or a reference name
    from ``REFERENCE_NAMES``).

    Raises:
        KeyError: naming the known kernels, when ``name`` is unregistered.
    """
    try:
        return _KERNELS[REFERENCE_NAMES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown SU3 kernel {name!r}; registered: {sorted(_KERNELS)}"
        ) from None


def kernel_names(
    *, backend: str | None = None, layout: Layout | None = None, form: str | None = None
) -> list[str]:
    """Sorted registered kernel names, optionally filtered by backend,
    plannable layout and form."""
    out = []
    for name, entry in _KERNELS.items():
        if backend is not None and backend not in entry.backends:
            continue
        if layout is not None and not entry.supports_layout(layout):
            continue
        if form is not None and entry.form != form:
            continue
        out.append(name)
    return sorted(out)
