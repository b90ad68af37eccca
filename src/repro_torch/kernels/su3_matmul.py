"""The SU3_Bench planar multiply: CUDA kernel wrappers and their plain versions.

Port of ``repro.kernels.su3_matmul.su3_mult_planar`` and of the serving
megakernel ``su3_mult_planar_batched`` (Pallas, TPU).  Both kernels are in
``repro_torch/csrc/su3_mult.cu`` and share one chain body; this module holds:

  * :func:`su3_mult_planar_plain` — the same computation in plain PyTorch:
    expand (two-row), the fixed-order multiply chain, compress, with the
    rounding of the reference's ``_expand_tile`` / ``_mult_tile`` /
    ``_compress_tile`` and of the CUDA kernel (every product, sum and
    difference rounds on its own, to bf16 as well under pure bf16).
  * :func:`su3_mult_planar` — the wrapper: for a CUDA tensor it checks the
    arguments, launches the kernel on the current stream and counts the
    launch in :data:`LAUNCHES`; for a CPU tensor it runs the plain version;
    any other device raises.
  * :func:`su3_mult_planar_batched_plain` / :func:`su3_mult_planar_batched`
    — the same for the slot-batched megakernel (counted in
    :data:`MEGA_LAUNCHES`): slot ``s`` chains ``clamp(slot_k[s], 0, max_k)``
    multiplies; depth 0 passes the slot through.
  * :func:`kernel_budget` — a kernel's registers, shared memory and
    occupancy per thread block, from ``cudaFuncGetAttributes`` (the port's
    counterpart of the reference's VMEM estimate ``vmem_bytes``).

Layout contract (the physical planar layouts, read in place by the kernels):
  a: SoA (2, rows, S) or AoSoA (S // T, 2, rows, T); rows = 36, or 24 for
     two-row storage; words f32 or bf16.  A batch of lattices (or a slot
     table) puts one more axis in front: (B, 2, rows, S) / (B, S//T, 2,
     rows, T).
  b: (2, 36) for one lattice, (B, 2, 36) for a batch; the same word dtype
  slot_k (megakernel): (B,) int32, on a's device
  -> c shaped like a
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import _build

LINKS, SU3 = 4, 3
ROWS = LINKS * SU3 * SU3  # 36 complex entries per site
COMP_ROWS = LINKS * 2 * SU3  # 24: two-row compressed gauge (12 reals/link)
DEFAULT_TILE = 512

# kernel modes, as su3_mult.cu numbers them
_MODE_F32, _MODE_BF16, _MODE_BF16_ACC_F32 = 0, 1, 2


def _flat(j: int, k: int, l: int) -> int:
    return (j * SU3 + k) * SU3 + l


# full-form row ids of the stored rows, in compressed row order
_COMP_TO_FULL = tuple(
    _flat(j, k, l) for j in range(LINKS) for k in range(2) for l in range(SU3)
)

# _mult_tile's operand rows, as gathers over all 36 outputs at once: output
# row (j, k, m) takes A row (j, k, l) and B row (j, l, m) at step l.
_OUT = [(j, k, m) for j in range(LINKS) for k in range(SU3) for m in range(SU3)]
_A_ROWS = tuple(tuple(_flat(j, k, l) for j, k, m in _OUT) for l in range(SU3))
_B_ROWS = tuple(tuple(_flat(j, l, m) for j, k, m in _OUT) for l in range(SU3))

# _expand_tile's operands: row2[l] = conj(r0[l1]*r1[l2] - r0[l2]*r1[l1])
_R2 = [(j, l) for j in range(LINKS) for l in range(SU3)]
_R2_OUT = tuple(_flat(j, 2, l) for j, l in _R2)
_R2_A = tuple(_flat(j, 0, (l + 1) % 3) for j, l in _R2)
_R2_B = tuple(_flat(j, 1, (l + 2) % 3) for j, l in _R2)
_R2_C = tuple(_flat(j, 0, (l + 2) % 3) for j, l in _R2)
_R2_D = tuple(_flat(j, 1, (l + 1) % 3) for j, l in _R2)


def _rows(x: torch.Tensor, idx: tuple[int, ...]) -> torch.Tensor:
    return x[:, list(idx)]


def expand_tile(a: torch.Tensor) -> torch.Tensor:
    """(2, 24, T) two-row f32 tile -> (2, 36, T): rebuild each link's row 2
    as ``conj(row0 x row1)`` with the reference's operand grouping."""
    full = a.new_zeros((2, ROWS) + tuple(a.shape[2:]))
    full[:, list(_COMP_TO_FULL)] = a
    (a_r, a_i), (b_r, b_i) = _rows(full, _R2_A), _rows(full, _R2_B)
    (c_r, c_i), (d_r, d_i) = _rows(full, _R2_C), _rows(full, _R2_D)
    xr = (a_r * b_r - a_i * b_i) - (c_r * d_r - c_i * d_i)
    xi = (a_r * b_i + a_i * b_r) - (c_r * d_i + c_i * d_r)
    full[0, list(_R2_OUT)] = xr
    full[1, list(_R2_OUT)] = -xi  # conjugate
    return full


def compress_tile(c: torch.Tensor) -> torch.Tensor:
    """(2, 36, T) full tile -> (2, 24, T): drop each link's third row."""
    return _rows(c, _COMP_TO_FULL)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 (nearest even) and widen them back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def rounding(round_each: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """What follows every operation: bf16 rounding under pure bf16, else
    nothing (the f32 result stands)."""
    return round_bf16 if round_each else _keep


def mult_tile(a: torch.Tensor, b: torch.Tensor, round_each: bool = False) -> torch.Tensor:
    """C = A (x) B on a (2, 36, T) f32 tile with a (2, 36) f32 B.

    Per output entry, in the reference's ``_mult_tile`` order:
    ``cr = ar*br - ai*bi`` then ``cr = (cr + ar*br) - ai*bi`` for l = 1, 2
    (and ``ci = (ci + ar*bi) + ai*br``); each op rounds on its own, and
    ``round_each`` (pure bf16) rounds each op's result to bf16 as well.
    """
    r = rounding(round_each)
    cr = ci = None
    for l in range(SU3):
        ar, ai = _rows(a, _A_ROWS[l])
        br, bi = (b[:, list(_B_ROWS[l])][..., None]).unbind(0)
        if cr is None:
            cr = r(r(ar * br) - r(ai * bi))
            ci = r(r(ar * bi) + r(ai * br))
        else:
            cr = r(r(cr + r(ar * br)) - r(ai * bi))
            ci = r(r(ci + r(ar * bi)) + r(ai * br))
    return torch.stack([cr, ci], dim=0)


def su3_mult_planar_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    k_iters: int = 1,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel on a planar (2, rows, S) tile.

    Works at f32 on every storage dtype.  Pure bf16 storage rounds to bf16
    after every operation of the chain; bf16 storage with
    ``accum_dtype="float32"`` rounds once, on the way out.  Two-row storage
    rebuilds row 2 but never reads it: rows 0/1 of C depend only on rows 0/1
    of A.
    """
    round_each = a.dtype == torch.bfloat16 and accum_dtype != "float32"
    x, bw = a.to(torch.float32), b.to(torch.float32)
    if compressed:
        x = expand_tile(x)
    for _ in range(k_iters):
        x = mult_tile(x, bw, round_each)
    if compressed:
        x = compress_tile(x)
    return x.to(a.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LaunchCounter:
    """Launches of one CUDA kernel, counted by its wrapper and nowhere else."""

    name: str
    count: int = 0


LAUNCHES = LaunchCounter("su3_mult_planar")
MEGA_LAUNCHES = LaunchCounter("su3_mult_planar_batched")


def _library() -> ctypes.CDLL:
    lib = _build.load("su3_mult")
    if not getattr(lib, "_repro_typed", False):
        lib.su3_mult_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.su3_mult_planar.restype = ctypes.c_int
        lib.su3_mult_planar_batched.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.su3_mult_planar_batched.restype = ctypes.c_int
        lib.su3_mult_planar_attributes.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.su3_mult_planar_attributes.restype = ctypes.c_int
        lib.su3_error_string.argtypes = [ctypes.c_int]
        lib.su3_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _mode(dtype: torch.dtype, accum_dtype: str | None, kernel: str = "su3_mult_planar") -> int:
    """The kernel mode of a storage dtype and accumulation width (the
    numbering every ``csrc`` source shares)."""
    if dtype == torch.float32:
        return _MODE_F32
    if dtype == torch.bfloat16:
        return _MODE_BF16_ACC_F32 if accum_dtype == "float32" else _MODE_BF16
    raise ValueError(f"{kernel} stores float32 or bfloat16 words, got {dtype}")


def _check_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t; every ``csrc`` library exports
    ``su3_error_string`` to name it."""
    if rc != 0:
        msg = lib.su3_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def kernel_budget(
    dtype: torch.dtype = torch.float32,
    accum_dtype: str | None = None,
    compressed: bool = False,
    aosoa: bool = False,
    megakernel: bool = False,
) -> dict[str, int | float | None]:
    """One instantiation's per-block budget, from ``cudaFuncGetAttributes``
    and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    CUDA device; ``megakernel`` picks the slot-batched kernel.

    Returns:
        ``num_regs`` per thread, ``shared_bytes`` (static) and
        ``local_bytes`` (register spills) per block, ``threads_per_block``,
        ``blocks_per_sm`` resident, and ``occupancy`` — resident threads over
        the SM's maximum (None where PyTorch does not report that maximum).
    """
    lib = _library()
    out = (ctypes.c_int * 6)()
    rc = lib.su3_mult_planar_attributes(_mode(dtype, accum_dtype), int(compressed), int(aosoa),
                                        int(megakernel), out)
    _check_error(lib, rc, "cudaFuncGetAttributes")
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


def _geometry(a: torch.Tensor, rows: int, batched: bool) -> tuple[int, int]:
    """``(n_sites, lane)`` of a physical tensor (one lattice, or a batch of
    them when ``batched``): lane 0 is SoA, else the AoSoA tile width.

    Raises:
        ValueError: on any other shape.
    """
    shape = tuple(a.shape[1:] if batched else a.shape)
    lead = "(B, " if batched else "("
    if len(shape) == 3 and shape[:2] == (2, rows):
        return shape[2], 0
    if len(shape) == 4 and shape[1:3] == (2, rows):
        return shape[0] * shape[3], shape[3]
    raise ValueError(
        f"a must be {lead}2, {rows}, S) or {lead}tiles, 2, {rows}, T), got {tuple(a.shape)}"
    )


def _check_b(a: torch.Tensor, b: torch.Tensor) -> None:
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError(
            f"b must match a's device and dtype: a {a.device}/{a.dtype}, b {b.device}/{b.dtype}"
        )


def _check_contiguous(*operands: torch.Tensor) -> None:
    if not all(x.is_contiguous() for x in operands):
        raise ValueError("the SU3 multiply kernels need contiguous operands")


def _check_out(a: torch.Tensor, out: torch.Tensor | None, alias: bool) -> None:
    if out is None:
        return
    if alias:
        raise ValueError("pass alias (C into A) or out, not both")
    if (out.shape != a.shape or out.dtype != a.dtype or out.device != a.device
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(a.shape)} {a.dtype} tensor on "
                         f"{a.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")


def _plain_physical(
    a: torch.Tensor, b: torch.Tensor, k_iters: int, lane: int,
    accum_dtype: str | None, compressed: bool,
) -> torch.Tensor:
    """The plain version on ONE physical lattice (SoA, or AoSoA with tile
    width ``lane``), through the flattened planar view."""
    rows = COMP_ROWS if compressed else ROWS
    if not lane:
        return su3_mult_planar_plain(a, b, k_iters=k_iters, accum_dtype=accum_dtype,
                                     compressed=compressed)
    view = torch.movedim(a, 0, 2).reshape(2, rows, -1)
    c = su3_mult_planar_plain(view, b, k_iters=k_iters, accum_dtype=accum_dtype,
                              compressed=compressed)
    return torch.movedim(c.reshape(2, rows, a.shape[0], lane), 2, 0)


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
    """Planar SU3 multiply, chained ``k_iters`` times in one launch.

    ``a`` is the physical SoA ``(2, rows, S)`` or AoSoA ``(S//T, 2, rows, T)``
    tensor, ``b`` the planar ``(2, 36)`` B; ``S`` must be a multiple of
    ``tile``.  A batch of lattices — ``a`` with a leading batch axis and
    ``b`` of shape ``(B, 2, 36)``, one B per lattice — runs in ONE launch
    (the counterpart of the reference's ``vmap`` over this kernel).
    ``alias`` writes C into A's storage and returns A; ``out`` (shaped
    like ``a``, on its device, contiguous) receives C instead of a new
    tensor.  ``accum_dtype="float32"`` runs the chain at f32 over bf16
    words; ``compressed`` streams two-row gauge blocks (rows = 24).

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version; any other device raises.
    """
    rows = COMP_ROWS if compressed else ROWS
    batched = b.ndim == 3
    if b.shape[-2:] != (2, ROWS) or (batched and b.shape[0] != a.shape[0]):
        raise ValueError(f"b must be (2, {ROWS}) or (B, 2, {ROWS}) matching a's batch, "
                         f"got {tuple(b.shape)}")
    n_sites, lane = _geometry(a, rows, batched)
    if k_iters < 1:
        raise ValueError(f"k_iters must be >= 1, got {k_iters}")
    if n_sites % tile:
        raise ValueError(f"site count {n_sites} is not a multiple of tile {tile}")
    mode = _mode(a.dtype, accum_dtype)  # validates the storage dtype
    _check_b(a, b)
    _check_out(a, out, alias)

    if a.device.type == "cuda":
        _check_contiguous(a, b)
        out = a if alias else (torch.empty_like(a) if out is None else out)
        lib = _library()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = lib.su3_mult_planar(
                a.data_ptr(), out.data_ptr(), b.data_ptr(), n_sites, lane, k_iters,
                mode, int(compressed), a.shape[0] if batched else 1, stream,
            )
        _check_error(lib, rc, "su3_mult_planar launch")
        LAUNCHES.count += 1
        return out
    if a.device.type != "cpu":
        raise ValueError(f"su3_mult_planar runs on cuda or cpu tensors, got {a.device}")
    if batched:
        c = torch.stack([_plain_physical(x, y, k_iters, lane, accum_dtype, compressed)
                         for x, y in zip(a, b)])
    else:
        c = _plain_physical(a, b, k_iters, lane, accum_dtype, compressed)
    if alias:
        return a.copy_(c)
    return c.contiguous() if out is None else out.copy_(c)


def su3_mult_planar_batched_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    slot_k: torch.Tensor,
    *,
    max_k: int = 8,
    accum_dtype: str | None = None,
    compressed: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the megakernel on a physical slot table:
    the :func:`su3_mult_planar_plain` chain per slot at depth
    ``clamp(slot_k[s], 0, max_k)``; a depth-0 slot is returned unchanged."""
    rows = COMP_ROWS if compressed else ROWS
    _n_sites, lane = _geometry(a, rows, True)
    depths = [min(max(k, 0), max_k) for k in slot_k.tolist()]  # the kernel's clamp
    return torch.stack([
        x.clone() if k == 0 else _plain_physical(x, y, k, lane, accum_dtype, compressed)
        for x, y, k in zip(a, b, depths)
    ]).contiguous()


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
    """The serving megakernel: ONE launch over a whole slot table.

    ``a`` is the physical slot table ``(slots, 2, rows, S)`` (SoA) or
    ``(slots, S//T, 2, rows, T)`` (AoSoA), ``b`` the per-slot planar B
    ``(slots, 2, 36)``, ``slot_k`` the ``(slots,)`` int32 chain depths on
    a's device.  Slot ``s`` chains ``clamp(slot_k[s], 0, max_k)``
    multiplies; depth 0 passes it through.  The kernel reads ``slot_k`` on
    the device, so a launch costs no host round trip.  ``alias`` writes C
    into A's storage (a dead slot is then not touched at all); ``out``
    (shaped like ``a``, on its device, contiguous) receives C instead of a
    new tensor.

    A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version; any other device raises.
    """
    rows = COMP_ROWS if compressed else ROWS
    n_sites, lane = _geometry(a, rows, True)
    slots = a.shape[0]
    if tuple(b.shape) != (slots, 2, ROWS):
        raise ValueError(f"b must be ({slots}, 2, {ROWS}), got {tuple(b.shape)}")
    if tuple(slot_k.shape) != (slots,):
        raise ValueError(f"slot_k must be ({slots},), got {tuple(slot_k.shape)}")
    if n_sites % tile:
        raise ValueError(f"site count {n_sites} is not a multiple of tile {tile}")
    if max_k < 1:
        raise ValueError(f"max_k must be >= 1, got {max_k}")
    mode = _mode(a.dtype, accum_dtype, "su3_mult_planar_batched")
    _check_b(a, b)
    _check_out(a, out, alias)

    if a.device.type == "cuda":
        if slot_k.dtype != torch.int32 or slot_k.device != a.device:
            raise ValueError(f"slot_k must be int32 on {a.device}, got {slot_k.dtype} "
                             f"on {slot_k.device}")
        _check_contiguous(a, b, slot_k)
        out = a if alias else (torch.empty_like(a) if out is None else out)
        lib = _library()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = lib.su3_mult_planar_batched(
                a.data_ptr(), out.data_ptr(), b.data_ptr(), slot_k.data_ptr(), n_sites, lane,
                max_k, mode, int(compressed), slots, stream,
            )
        _check_error(lib, rc, "su3_mult_planar_batched launch")
        MEGA_LAUNCHES.count += 1
        return out
    if a.device.type != "cpu":
        raise ValueError(f"su3_mult_planar_batched runs on cuda or cpu tensors, got {a.device}")
    c = su3_mult_planar_batched_plain(a, b, slot_k, max_k=max_k, accum_dtype=accum_dtype,
                                      compressed=compressed)
    if alias:
        return a.copy_(c)
    return c if out is None else out.copy_(c)
