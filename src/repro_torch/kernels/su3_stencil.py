"""The nearest-neighbour SU(3) stencil and the fused CG iteration body: CUDA
kernel wrappers and their plain versions.

Port of ``repro.kernels.su3_stencil`` (Pallas, TPU).  Per site x:

    out(x) = sum_mu [ U_mu(x) . v(x + mu_hat)  +  U_mu(x)^dagger . v(x - mu_hat) ]

over mu = x, y, z, t, with the site-local adjoint link (the reference's
simplification of staggered Dslash).  The neighbour gather happens outside
the kernels (``ExecutionPlan`` fills the direction-major ``v_nbr``).  Both
kernels live in ``repro_torch/csrc/su3_stencil.cu``; this module holds:

  * :func:`stencil_tile`, :func:`su3_stencil_planar_plain` and
    :func:`su3_cg_fused_planar_plain` — the same computations in plain
    PyTorch, in the reference's fixed order (mu outer, then l, forward
    before backward, each k's sum started from its first term) and with its
    rounding: every product, sum and difference rounds on its own, to bf16
    as well under pure bf16; bf16 storage with f32 accumulation narrows once
    on store;
  * :func:`su3_stencil_planar` and :func:`su3_cg_fused_planar` — the
    wrappers: for CUDA tensors they check the arguments, launch on the
    current stream and count the launch (:data:`STENCIL_LAUNCHES`,
    :data:`CG_LAUNCHES`); for CPU tensors they run the plain version; any
    other device raises;
  * :func:`kernel_budget` — each kernel's registers and occupancy.

Layout contract:
  u:            SoA (2, rows, S) or AoSoA (S // T, 2, rows, T), rows = 36
                or 24 (two-row), read in place
  v_nbr, r_nbr, p_nbr: (8, 2, 3, S), directions (+x, +y, +z, +t, -x, -y,
                -z, -t)
  r, p:         (2, 3, S)
  coefs:        (1, 2) float32 [beta, sigma] on the device; the kernel
                reads beta, sigma is for the plan's shift epilogue
  -> (2, 3, S) in the storage dtype (the CG body returns (p', S(p')))

The fixed order makes any site subset give the same bits as the full pass,
and makes the fused CG body equal the composed axpy + stencil at f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, su3_matmul
from repro_torch.kernels.su3_matmul import (
    COMP_ROWS, DEFAULT_TILE, LINKS, ROWS, SU3, LaunchCounter, _flat, expand_tile, rounding,
)

NBR_DIRS = 2 * LINKS  # +x +y +z +t -x -y -z -t

# 8 matrix-vector products x 9 complex MACs x 8 flops (4 mul + 4 add)
STENCIL_FLOPS_PER_SITE = NBR_DIRS * SU3 * SU3 * 8

# words streamed per site: U (72) + 8 neighbour vectors (8 x 6) + out (6)
STENCIL_WORDS_PER_SITE = 2 * ROWS + NBR_DIRS * 2 * SU3 + 2 * SU3

# two-row gauge: U shrinks 72 -> 48 words; the vector traffic is unchanged
STENCIL_COMP_WORDS_PER_SITE = 2 * COMP_ROWS + NBR_DIRS * 2 * SU3 + 2 * SU3

CG_COEFS = 2  # coefficient block columns: [beta, sigma]

# one CG iteration: the stencil chain plus six 12-flop vector passes
# (shift, x += alpha p, r -= alpha ap, p = r + beta p, <p, Ap>, <r, r>)
CG_ITER_FLOPS_PER_SITE = STENCIL_FLOPS_PER_SITE + 72

# extra words/site the fused CG kernel streams over the stencil: the second
# gathered field, the two centre vectors and the second output
CG_EXTRA_WORDS_PER_SITE = NBR_DIRS * 2 * SU3 + 3 * (2 * SU3)

# kernel ids of su3_stencil.cu's attribute query
_KERNEL_IDS = {"stencil": 0, "cg": 1}


# per (mu, l): the rows U[mu, k, l] and U[mu, l, k] for k = 0, 1, 2
_FWD_ROWS = tuple(tuple([_flat(mu, k, l) for k in range(SU3)] for l in range(SU3))
                  for mu in range(LINKS))
_BWD_ROWS = tuple(tuple([_flat(mu, l, k) for k in range(SU3)] for l in range(SU3))
                  for mu in range(LINKS))


def stencil_tile(u: torch.Tensor, v_nbr: torch.Tensor, round_each: bool = False) -> torch.Tensor:
    """out = sum_mu U_mu . v_fwd[mu] + U_mu^dag . v_bwd[mu] on f32 tiles.

    ``u`` (2, 36, T), ``v_nbr`` (8, 2, 3, T) -> (2, 3, T).  The three
    output colours k run side by side; each one's sum goes mu outer, l
    inner, forward then backward, starting from its first term, as the
    reference's ``_stencil_tile`` does.  Forward: ``tr = ur*vr - ui*vi``,
    ``ti = ur*vi + ui*vr``; backward with conj(U[mu, l, k]):
    ``sr = ur*vr + ui*vi``, ``si = ur*vi - ui*vr``.
    """
    r = rounding(round_each)
    acc_r = acc_i = None
    for mu in range(LINKS):
        for l in range(SU3):
            fr, fi = u[0, _FWD_ROWS[mu][l]], u[1, _FWD_ROWS[mu][l]]  # (3, T)
            br, bi = u[0, _BWD_ROWS[mu][l]], u[1, _BWD_ROWS[mu][l]]
            vfr, vfi = v_nbr[mu, 0, l], v_nbr[mu, 1, l]  # (T,)
            vbr, vbi = v_nbr[LINKS + mu, 0, l], v_nbr[LINKS + mu, 1, l]
            tr = r(r(fr * vfr) - r(fi * vfi))
            ti = r(r(fr * vfi) + r(fi * vfr))
            acc_r = tr if acc_r is None else r(acc_r + tr)
            acc_i = ti if acc_i is None else r(acc_i + ti)
            sr = r(r(br * vbr) + r(bi * vbi))
            si = r(r(br * vbi) - r(bi * vbr))
            acc_r = r(acc_r + sr)
            acc_i = r(acc_i + si)
    return torch.stack([acc_r, acc_i], dim=0)


def _round_each(dtype: torch.dtype, accum_dtype: str | None) -> bool:
    return dtype == torch.bfloat16 and accum_dtype != "float32"


def _links_f32(u: torch.Tensor, compressed: bool, round_each: bool) -> torch.Tensor:
    """Planar links widened to f32; two-row links get row 2 rebuilt in f32,
    narrowed to bf16 under pure bf16 as the reference's ``_expand_tile``
    narrows it to the working dtype."""
    x = u.to(torch.float32)
    if compressed:
        x = expand_tile(x)
        if round_each:
            x = su3_matmul.round_bf16(x)
    return x


def su3_stencil_planar_plain(
    u: torch.Tensor,
    v_nbr: torch.Tensor,
    *,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the stencil kernel on planar SoA links
    ``u`` (2, rows, S) and neighbours ``v_nbr`` (8, 2, 3, S)."""
    round_each = _round_each(u.dtype, accum_dtype)
    x = _links_f32(u, compressed, round_each)
    return stencil_tile(x, v_nbr.to(torch.float32), round_each).to(u.dtype)


def su3_cg_fused_planar_plain(
    u: torch.Tensor,
    r_nbr: torch.Tensor,
    p_nbr: torch.Tensor,
    r: torch.Tensor,
    p: torch.Tensor,
    coefs: torch.Tensor,
    *,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fused CG body: ``p' = r + beta p``
    at the centre and at the 8 neighbours (a product, then a sum), then the
    stencil on ``p'_nbr``.  Under pure bf16, beta is first rounded to bf16.

    Returns:
        ``(p', S(p'))``, both (2, 3, S) in the storage dtype.
    """
    round_each = _round_each(u.dtype, accum_dtype)
    rnd = rounding(round_each)
    f32 = torch.float32
    beta = rnd(coefs[0, 0].to(f32))
    x = _links_f32(u, compressed, round_each)
    p_new = rnd(r.to(f32) + rnd(beta * p.to(f32)))
    v_nbr = rnd(r_nbr.to(f32) + rnd(beta * p_nbr.to(f32)))
    return p_new.to(u.dtype), stencil_tile(x, v_nbr, round_each).to(u.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


STENCIL_LAUNCHES = LaunchCounter("su3_stencil_planar")
CG_LAUNCHES = LaunchCounter("su3_cg_fused_planar")


def _library() -> ctypes.CDLL:
    lib = _build.load("su3_stencil")
    if not getattr(lib, "_repro_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.su3_stencil_planar.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, ptr]
        lib.su3_stencil_planar.restype = i32
        lib.su3_cg_fused_planar.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr,
        ]
        lib.su3_cg_fused_planar.restype = i32
        lib.su3_stencil_attributes.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
        lib.su3_stencil_attributes.restype = i32
        lib.su3_error_string.argtypes = [i32]
        lib.su3_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def kernel_budget(
    kernel: str = "stencil",
    dtype: torch.dtype = torch.float32,
    accum_dtype: str | None = None,
    compressed: bool = False,
    aosoa: bool = False,
) -> dict[str, int | float | None]:
    """One instantiation's per-block budget on the current CUDA device.

    Args:
        kernel: ``"stencil"`` or ``"cg"``.

    Returns:
        The keys of :func:`repro_torch.kernels.su3_matmul.kernel_budget`:
        ``num_regs``, ``shared_bytes``, ``local_bytes`` (spills),
        ``max_threads_per_block``, ``threads_per_block``, ``blocks_per_sm``
        and ``occupancy``.
    """
    lib = _library()
    out = (ctypes.c_int * 6)()
    mode = su3_matmul._mode(dtype, accum_dtype, "su3_stencil_planar")
    rc = lib.su3_stencil_attributes(_KERNEL_IDS[kernel], mode, int(compressed), int(aosoa), out)
    su3_matmul._check_error(lib, rc, "cudaFuncGetAttributes")
    regs, shared, local, max_threads, threads, blocks = list(out)
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    per_sm = getattr(props, "max_threads_per_multi_processor", None)
    return {
        "num_regs": regs,
        "shared_bytes": shared,
        "local_bytes": local,
        "max_threads_per_block": max_threads,
        "threads_per_block": threads,
        "blocks_per_sm": blocks,
        "occupancy": blocks * threads / per_sm if per_sm else None,
    }


def _link_sites(u: torch.Tensor, compressed: bool, tile: int, what: str) -> tuple[int, int]:
    """Validate the link tensor; return ``(n_sites, lane)`` (lane 0 = SoA)."""
    rows = COMP_ROWS if compressed else ROWS
    planar = u.ndim == 3 and tuple(u.shape[:2]) == (2, rows)
    tiled = u.ndim == 4 and tuple(u.shape[1:3]) == (2, rows)
    if not (planar or tiled):
        raise ValueError(
            f"{what}: u must be (2, {rows}, S) or (tiles, 2, {rows}, T), got {tuple(u.shape)}"
        )
    n_sites = u.shape[0] * u.shape[3] if tiled else u.shape[2]
    if n_sites % tile:
        raise ValueError(f"{what}: site count {n_sites} is not a multiple of tile {tile}")
    return n_sites, (u.shape[3] if tiled else 0)


def _check_operands(what: str, u: torch.Tensor, n_sites: int, **vecs: torch.Tensor) -> None:
    """Shapes, dtype, device and (on CUDA) contiguity of the vector operands."""
    for name, t in vecs.items():
        want = (NBR_DIRS, 2, SU3, n_sites) if name.endswith("_nbr") else (2, SU3, n_sites)
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {want}, got {tuple(t.shape)}")
    for name, t in vecs.items():
        if t.dtype != u.dtype or t.device != u.device:
            raise ValueError(
                f"{what}: {name} must match u's device and dtype: u {u.device}/{u.dtype}, "
                f"{name} {t.device}/{t.dtype}"
            )
    if u.device.type == "cuda" and not all(t.is_contiguous() for t in (u, *vecs.values())):
        raise ValueError(f"{what} needs contiguous operands")
    if u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {u.device}")


def _planar(u: torch.Tensor) -> torch.Tensor:
    """AoSoA (tiles, 2, rows, T) -> the planar (2, rows, S) the plain version
    takes (a copy); SoA as it is."""
    if u.ndim == 4:
        return torch.movedim(u, 0, 2).reshape(2, u.shape[2], -1)
    return u


def su3_stencil_planar(
    u: torch.Tensor,
    v_nbr: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> torch.Tensor:
    """The nearest-neighbour stencil: links ``u`` and gathered neighbours
    ``v_nbr`` (8, 2, 3, S) -> (2, 3, S).

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version; any other device raises.
    """
    what = "su3_stencil_planar"
    n_sites, lane = _link_sites(u, compressed, tile, what)
    mode = su3_matmul._mode(u.dtype, accum_dtype, what)
    _check_operands(what, u, n_sites, v_nbr=v_nbr)
    if u.device.type == "cpu":
        return su3_stencil_planar_plain(_planar(u), v_nbr, accum_dtype=accum_dtype,
                                        compressed=compressed)
    out = torch.empty((2, SU3, n_sites), dtype=u.dtype, device=u.device)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.su3_stencil_planar(u.data_ptr(), v_nbr.data_ptr(), out.data_ptr(), n_sites,
                                    lane, mode, int(compressed), stream)
    su3_matmul._check_error(lib, rc, f"{what} launch")
    STENCIL_LAUNCHES.count += 1
    return out


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
    """The fused CG body: ``(p', S(p'))`` with ``p' = r + beta p``, beta
    read from ``coefs[0, 0]`` (a (1, 2) float32 tensor on u's device).

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version; any other device raises.
    """
    what = "su3_cg_fused_planar"
    n_sites, lane = _link_sites(u, compressed, tile, what)
    mode = su3_matmul._mode(u.dtype, accum_dtype, what)
    _check_operands(what, u, n_sites, r_nbr=r_nbr, p_nbr=p_nbr, r=r, p=p)
    if tuple(coefs.shape) != (1, CG_COEFS) or coefs.dtype != torch.float32:
        raise ValueError(f"{what}: coefs must be (1, 2) float32, got {tuple(coefs.shape)} "
                         f"{coefs.dtype}")
    if coefs.device != u.device:
        raise ValueError(f"{what}: coefs must lie on u's device {u.device}, got {coefs.device}")
    if u.device.type == "cpu":
        return su3_cg_fused_planar_plain(_planar(u), r_nbr, p_nbr, r, p, coefs,
                                         accum_dtype=accum_dtype, compressed=compressed)
    if not coefs.is_contiguous():
        raise ValueError(f"{what} needs contiguous operands")
    p_new = torch.empty((2, SU3, n_sites), dtype=u.dtype, device=u.device)
    s = torch.empty_like(p_new)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.su3_cg_fused_planar(
            u.data_ptr(), r_nbr.data_ptr(), p_nbr.data_ptr(), r.data_ptr(), p.data_ptr(),
            coefs.data_ptr(), p_new.data_ptr(), s.data_ptr(), n_sites, lane, mode,
            int(compressed), stream,
        )
    su3_matmul._check_error(lib, rc, f"{what} launch")
    CG_LAUNCHES.count += 1
    return p_new, s
