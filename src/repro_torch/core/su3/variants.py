"""The paper's SU3_Bench implementation variants in PyTorch (port of
``repro.core.su3.variants``).

The reference writes these as XLA programs, not Pallas kernels, so plain
PyTorch is their port.  Each keeps the shape in which the reference
expresses the computation:

  version0        loop-nest faithful: one product per link.
  version3        fully collapsed: one flat (site, link, row, col) work-item
                  axis with gathered operand rows.
  versionX        the simplest parallel form: one einsum.
  version_gemm    paper §4 explicit GEMM: planar SoA operands, the 3x3x3
                  complex product unrolled into real multiply-add chains.
  version_blocked paper §5.4 blocked GEMM: version_gemm per AoSoA site tile.

All take and return the canonical complex form, so they are interchangeable
and testable against ``kernels.ref.su3_mult_ref``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.su3 import layouts, registry
from repro_torch.core.su3.layouts import Layout
from repro_torch.kernels import ref as kref

Variant = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def register(
    name: str, *, variant_layouts: tuple[Layout, ...] = (Layout.AOS, Layout.SOA, Layout.AOSOA)
) -> Callable[[Variant], Variant]:
    """Register a plain-torch variant in the kernel registry (canonical form)."""
    return registry.register_kernel(
        name, layouts=variant_layouts, backends=("torch",), form=registry.CANONICAL
    )


def get_variant(name: str) -> Variant:
    entry = registry.get_kernel(name)
    if entry.form != registry.CANONICAL:
        raise KeyError(f"{name!r} is not a canonical torch variant")
    return entry.fn


def variant_names() -> list[str]:
    """Names of the canonical variants — excludes the CUDA planar kernel."""
    return registry.kernel_names(backend="torch", form=registry.CANONICAL)


@register("version0")
def version0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Loop-nest faithful: one product per link, stacked on the link axis."""
    c = [torch.einsum("skl,lm->skm", a[:, j], b[j]) for j in range(layouts.LINKS)]
    return torch.stack(c, dim=1)


@register("version3")
def version3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fully-collapsed work-item form (the paper's worst performer).

    Flattens (site, link, row, col) into one axis and gathers operand rows,
    as Version 2/3 rebuild their indices from a work-item id.
    """
    n_sites = a.shape[0]
    work = torch.arange(n_sites * layouts.LINKS * layouts.SU3 * layouts.SU3, device=a.device)
    s_idx, j_idx, k_idx, m_idx = torch.unravel_index(
        work, (n_sites, layouts.LINKS, layouts.SU3, layouts.SU3)
    )
    a_rows = a[s_idx, j_idx, k_idx, :]  # (work, 3)
    b_cols = b[j_idx, :, m_idx]  # (work, 3)
    c_flat = torch.sum(a_rows * b_cols, dim=-1)
    return c_flat.reshape(n_sites, layouts.LINKS, layouts.SU3, layouts.SU3)


@register("versionX")
def version_x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's VersionX: simplest parallel formulation — one einsum."""
    return kref.su3_mult_ref(a, b)


def _gemm_planar_unrolled(a_p: torch.Tensor, b_p: torch.Tensor) -> torch.Tensor:
    """Fully unrolled 3x3x3 complex product over planar site vectors.

    a_p: (2, 4, 3, 3, ...) with any trailing site axes; b_p: (2, 4, 3, 3).
    The k/l/m loops are unrolled as in the paper's hand-written GEMM.
    """
    ar, ai = a_p[0], a_p[1]
    br, bi = b_p[0], b_p[1]
    L, N = layouts.LINKS, layouts.SU3
    out_r = [[[None] * N for _ in range(N)] for _ in range(L)]
    out_i = [[[None] * N for _ in range(N)] for _ in range(L)]
    for j in range(L):
        for k in range(N):
            for m in range(N):
                cr = ar[j, k, 0] * br[j, 0, m] - ai[j, k, 0] * bi[j, 0, m]
                ci = ar[j, k, 0] * bi[j, 0, m] + ai[j, k, 0] * br[j, 0, m]
                for l in range(1, N):
                    cr = cr + ar[j, k, l] * br[j, l, m] - ai[j, k, l] * bi[j, l, m]
                    ci = ci + ar[j, k, l] * bi[j, l, m] + ai[j, k, l] * br[j, l, m]
                out_r[j][k][m] = cr
                out_i[j][k][m] = ci

    def stack(o: list) -> torch.Tensor:
        return torch.stack([torch.stack([torch.stack(row) for row in link]) for link in o])

    return torch.stack([stack(out_r), stack(out_i)], dim=0)


@register("version_gemm")
def version_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Paper §4: explicit unrolled GEMM on planar SoA data."""
    c_p = _gemm_planar_unrolled(layouts.pack_soa(a), layouts.to_planar(b))
    return layouts.unpack_soa(c_p, a.dtype)


@register("version_blocked")
def version_blocked(a: torch.Tensor, b: torch.Tensor, *, lane: int = layouts.LANE) -> torch.Tensor:
    """Paper §5.4: blocked GEMM — the unrolled product per AoSoA site tile.

    Every tile runs the same per-site arithmetic, so all tiles go through
    one call with the tile axis kept beside the lane axis.
    """
    n_sites = a.shape[0]
    t = layouts.pack_aosoa(a, lane=lane)  # (tiles, 2, 4, 3, 3, lane)
    c = _gemm_planar_unrolled(torch.movedim(t, 0, -2), layouts.to_planar(b))
    return layouts.unpack_aosoa(torch.movedim(c, -2, 0), n_sites, a.dtype)
