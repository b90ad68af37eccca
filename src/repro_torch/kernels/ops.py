"""Public entry points of the SU3 kernels, registered for the plan (port of
``repro.kernels.ops``).

There is no interpret mode: the tensor's device decides the path.  A CUDA
tensor goes to the hand-written kernel (or raises); a CPU tensor goes to
the kernel's plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.su3 import layouts, registry
from repro_torch.core.su3.layouts import Layout
from repro_torch.kernels import ref as kref
from repro_torch.kernels import su3_matmul, su3_stencil

DEFAULT_TILE = su3_matmul.DEFAULT_TILE


@registry.register_kernel(
    "cuda",
    layouts=(Layout.SOA, Layout.AOSOA),
    backends=("cuda",),
    form=registry.PLANAR,
    supports_fused=True,
    supports_accum=True,
    supports_compressed=True,
)
def su3_mult_planar(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    k_iters: int = 1,
    alias: bool = False,
    accum_dtype: str | None = None,
    compressed: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Planar entry point: a SoA (2, 36|24, S) or AoSoA (S//T, 2, 36|24, T),
    b (2, 36).

    ``k_iters`` chains K multiplies in one launch; ``alias`` writes C into
    A's storage, ``out`` into a given tensor; ``accum_dtype`` runs the
    chain at f32 over bf16 words; ``compressed`` streams two-row gauge
    blocks.
    """
    return su3_matmul.su3_mult_planar(
        a, b, tile=tile, k_iters=k_iters, alias=alias, accum_dtype=accum_dtype,
        compressed=compressed, out=out,
    )


@registry.register_kernel(
    "cuda_megakernel",
    layouts=(Layout.SOA, Layout.AOSOA),
    backends=("cuda",),
    form=registry.BATCHED,
    supports_fused=True,
    supports_accum=True,
    supports_compressed=True,
)
def su3_mult_planar_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    slot_k: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    max_k: int = 8,
    alias: bool = False,
    accum_dtype: str | None = None,
    compressed: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Slot-batched entry: a physical slot table SoA (slots, 2, 36|24, S) or
    AoSoA (slots, S//T, 2, 36|24, T), b (slots, 2, 36), slot_k (slots,)
    int32 on a's device; slot s chains clamp(slot_k[s], 0, max_k)
    multiplies in ONE launch (0 = pass-through), into ``out`` when given."""
    return su3_matmul.su3_mult_planar_batched(
        a, b, slot_k, tile=tile, max_k=max_k, alias=alias, accum_dtype=accum_dtype,
        compressed=compressed, out=out,
    )


@registry.register_kernel(
    "cuda_stencil",
    layouts=(Layout.SOA, Layout.AOSOA),
    backends=("cuda",),
    form=registry.STENCIL,
    supports_accum=True,
    supports_compressed=True,
)
def su3_stencil_planar(
    u: torch.Tensor,
    v_nbr: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> torch.Tensor:
    """Stencil entry: u SoA (2, 36|24, S) or AoSoA (S//T, 2, 36|24, T),
    v_nbr (8, 2, 3, S) direction-major gathered neighbours -> (2, 3, S)."""
    return su3_stencil.su3_stencil_planar(
        u, v_nbr, tile=tile, accum_dtype=accum_dtype, compressed=compressed
    )


@registry.register_kernel(
    "cuda_cg",
    layouts=(Layout.SOA, Layout.AOSOA),
    backends=("cuda",),
    form=registry.STENCIL_AXPY,
    supports_accum=True,
    supports_compressed=True,
)
def su3_cg_fused_planar(
    u: torch.Tensor,
    r_nbr: torch.Tensor,
    p_nbr: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    coefs: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused CG body entry: u as above, (r_nbr, p_nbr) (8, 2, 3, S), (r, p)
    (2, 3, S), coefs (1, 2) [beta, sigma] -> (p', S(p')); the sigma shift
    runs in the plan's shared epilogue."""
    return su3_stencil.su3_cg_fused_planar(
        u, r_nbr, p_nbr, r, p, coefs, tile=tile, accum_dtype=accum_dtype,
        compressed=compressed,
    )


def su3_mult(a: torch.Tensor, b: torch.Tensor, *, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Canonical complex entry point matching kernels.ref.su3_mult_ref.

    a: (n_sites, 4, 3, 3) complex, b: (4, 3, 3) complex, on one device.
    Packs to planar SoA, pads sites to the tile, runs the kernel, unpacks.
    """
    n_sites = a.shape[0]
    pad = (-n_sites) % tile
    a_p = layouts.pack_soa(a).reshape(2, su3_matmul.ROWS, n_sites)
    if pad:
        a_p = torch.nn.functional.pad(a_p, (0, pad))
    b_p = layouts.to_planar(b).reshape(2, su3_matmul.ROWS).contiguous()
    c_p = su3_matmul.su3_mult_planar(a_p.contiguous(), b_p, tile=tile)
    c_p = c_p[:, :, :n_sites].reshape(2, layouts.LINKS, layouts.SU3, layouts.SU3, n_sites)
    return layouts.unpack_soa(c_p, a.dtype)


# Re-exported oracles so call sites can flip between kernel and reference
# with one name change.
su3_mult_ref = kref.su3_mult_ref
su3_mult_planar_ref = kref.su3_mult_planar_ref
