"""Roofline bounds of the port's kernels on a Hopper card (port of the part
of ``repro.core.roofline`` that needs no compiled program): the multiply, the
serving megakernel over a slot table, the stencil, one CG iteration and the
prefill attention.

The reference derives its terms from XLA's HLO and carries TPU constants;
neither applies here.  The port's bound is analytic: the bytes the multiply
must move (the port's ``TrafficModel``) over the card's HBM rate, and its
flops over the card's FP32 CUDA-core rate (the SU3 product is a K=3
complex contraction that tensor cores cannot use), whichever is larger.
The attention bound counts its flops at the peak of its operands' type:
the bf16 tensor-core rate for bf16, the FP32 CUDA-core rate for f32.

Constants are NVIDIA's H100 datasheet figures (dense, at the full power
limit).  A card this module does not know has no spec, and its bound is
``None``: it is not guessed.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import su3_stencil


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_fp32: float  # FP32 on the CUDA cores, flop/s
    hbm_bw: float  # bytes/s
    hbm_bytes: float  # device memory
    peak_flops_bf16: float  # bf16 on the tensor cores, dense, flop/s
    peer_bw: float  # bytes/s to another card, per direction


# NVIDIA H100 datasheet: SXM5 67 TFLOP/s FP32, 989 TFLOP/s bf16 dense,
# 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s in total (450 GB/s a direction);
# PCIe 51 TFLOP/s FP32, 756 TFLOP/s bf16 dense, 2.0 TB/s HBM2e, 80 GB, and
# without an NVLink bridge its peers are across PCIe Gen5 x16 (64 GB/s a
# direction).
H100_SXM = HardwareSpec("h100_sxm", peak_flops_fp32=67e12, hbm_bw=3.35e12, hbm_bytes=80e9,
                        peak_flops_bf16=989e12, peer_bw=450e9)
H100_PCIE = HardwareSpec("h100_pcie", peak_flops_fp32=51e12, hbm_bw=2.0e12, hbm_bytes=80e9,
                         peak_flops_bf16=756e12, peer_bw=64e9)

HARDWARE = {h.name: h for h in (H100_SXM, H100_PCIE)}


def hardware_for_device(name: str) -> HardwareSpec | None:
    """The spec for a ``torch.cuda.get_device_name()`` string, else None.

    "NVIDIA H100 80GB HBM3" is the SXM part, "NVIDIA H100 PCIe" the PCIe
    part; any other name (another card, H100 NVL, the CPU) has no spec.
    """
    if "H100" not in name:
        return None
    if "PCIe" in name:
        return H100_PCIE
    if "HBM3" in name or "SXM" in name:
        return H100_SXM
    return None


def current_hardware() -> HardwareSpec | None:
    """The spec of CUDA device 0, or None without CUDA or for an unknown card."""
    if not torch.cuda.is_available():
        return None
    return hardware_for_device(torch.cuda.get_device_name(0))


@dataclasses.dataclass(frozen=True)
class SU3Roofline:
    """The bound of one launch of a k-chain over ``n_sites`` sites."""

    name: str
    hw: HardwareSpec
    flops: float  # useful flops of the whole chain
    bytes: float  # bytes the launch must move
    peak_flops: float | None = None  # the rate of the operands' type; None: FP32

    @property
    def compute_s(self) -> float:
        return self.flops / (self.peak_flops or self.hw.peak_flops_fp32)

    @property
    def memory_s(self) -> float:
        return self.bytes / self.hw.hbm_bw

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_s > self.memory_s else "bytes"


def analytic_su3_report(
    *,
    n_sites: int,
    bytes_per_site_rw: int,
    k: int = 1,
    hw: HardwareSpec | None = None,
) -> SU3Roofline:
    """Analytic bound of a fused k-chain: the A/C bytes move once, the
    864 flops/site are done k times.

    Args:
        n_sites: live lattice sites.
        bytes_per_site_rw: read A + write C bytes per site (TrafficModel).
        k: multiplies chained in the launch.
        hw: the card; defaults to CUDA device 0's spec.

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    return SU3Roofline(
        name=f"su3_analytic_L4={n_sites}_k{k}",
        hw=hw,
        flops=864.0 * n_sites * k,
        bytes=float(bytes_per_site_rw) * n_sites,
    )


def megakernel_bound(
    slot_k: list[int],
    *,
    n_sites: int,
    rows: int = 36,
    word_bytes: int = 4,
    max_k: int = 8,
    in_place: bool = True,
    hw: HardwareSpec | None = None,
) -> SU3Roofline:
    """Bound of one megakernel launch over a slot table, from the depths
    this launch runs.

    A live slot (depth ``clamp(k, 0, max_k) > 0``) reads A and writes C
    once (``2 x 2 x rows`` words per site) and reads its B (72 words); its
    flops are 864 per site per multiply.  A dead slot is counted as the
    kernel treats it: nothing in place, a read and a write of its words out
    of place (a copy, no flops).

    Args:
        slot_k: the per-slot depths of the launch.
        n_sites: sites per slot (padded: what the kernel runs).
        rows: planar rows of the stored form (36, or 24 two-row).
        word_bytes: 4 for f32 words, 2 for bf16.
        max_k: the launch's clamp.
        in_place: whether the table is written in place.
        hw: the card; defaults to CUDA device 0's spec.

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    slot_bytes = 2 * 2 * rows * word_bytes * n_sites  # read A, write C
    depths = [min(max(int(k), 0), max_k) for k in slot_k]
    live = sum(1 for k in depths if k)
    dead = len(depths) - live
    return SU3Roofline(
        name=f"su3_megakernel_{len(depths)}slots",
        hw=hw,
        flops=864.0 * n_sites * sum(depths),
        bytes=float(live * (slot_bytes + 2 * 36 * word_bytes)
                    + (0 if in_place else dead * slot_bytes)),
    )


def _stencil_kernel_words(cfg: Any) -> int:
    if cfg.is_compressed:
        return su3_stencil.STENCIL_COMP_WORDS_PER_SITE
    return su3_stencil.STENCIL_WORDS_PER_SITE


def stencil_bound(cfg: Any, hw: HardwareSpec | None = None) -> SU3Roofline:
    """Bound of one stencil kernel launch over ``cfg``'s lattice: its words
    per site (126, or 102 two-row) at the storage width, each read or
    written once, against 576 flops/site.  The neighbour gather before it
    is not counted (see :func:`cg_iteration_bound` for that term).

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    n = cfg.shape.n_sites
    return SU3Roofline(
        name=f"su3_stencil_L{cfg.L}",
        hw=hw,
        flops=float(su3_stencil.STENCIL_FLOPS_PER_SITE) * n,
        bytes=float(_stencil_kernel_words(cfg) * cfg.word_bytes) * n,
    )


# one gather of a vector field: 8 directions x 6 words read and written
GATHER_WORDS_PER_SITE = 2 * 8 * 6
# the CG epilogue's vector passes per site: shift (read p', S; write ap: 18),
# <p, ap> (12), the x/r update (read x, r, p, ap; write x, r: 36), <r, r> (6)
CG_EPILOGUE_WORDS_PER_SITE = 18 + 12 + 36 + 6


def cg_iteration_bound(cfg: Any, hw: HardwareSpec | None = None) -> dict[str, SU3Roofline]:
    """Bound of one fused CG iteration over ``cfg``'s lattice, term by term.

    Returns:
        ``{"kernel", "gathers", "epilogue", "total"}``: the fused kernel
        (192 words/site, 168 two-row), the two neighbour gathers (96 words
        each: the index tables are not counted), the epilogue's vector
        passes (72 words), all at the storage width, and their sum with the
        iteration's 648 flops/site.

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    n, wb = cfg.shape.n_sites, cfg.word_bytes
    kernel_words = _stencil_kernel_words(cfg) + su3_stencil.CG_EXTRA_WORDS_PER_SITE
    stencil_flops = float(su3_stencil.STENCIL_FLOPS_PER_SITE) * n
    terms = {
        "kernel": SU3Roofline(f"su3_cg_fused_L{cfg.L}", hw, stencil_flops,
                              float(kernel_words * wb) * n),
        "gathers": SU3Roofline(f"cg_gathers_L{cfg.L}", hw, 0.0,
                               float(2 * GATHER_WORDS_PER_SITE * wb) * n),
        "epilogue": SU3Roofline(
            f"cg_epilogue_L{cfg.L}", hw,
            float(su3_stencil.CG_ITER_FLOPS_PER_SITE - su3_stencil.STENCIL_FLOPS_PER_SITE) * n,
            float(CG_EPILOGUE_WORDS_PER_SITE * wb) * n),
    }
    terms["total"] = SU3Roofline(
        f"cg_iteration_L{cfg.L}", hw,
        sum(t.flops for t in terms.values()), sum(t.bytes for t in terms.values()),
    )
    return terms


def visible_pairs(sq: int, skv: int, *, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs that attention scores: all ``sq * skv``, or under
    the causal mask those with key j <= i + q_offset."""
    if not causal:
        return sq * skv
    # query i sees min(skv, max(0, i + q_offset + 1)) keys
    total = 0
    lo = max(0, -q_offset)  # first query that sees any key
    full = max(lo, min(sq, skv - q_offset))  # from here on a query sees all skv keys
    if full > lo:  # queries lo .. full-1 see i + q_offset + 1 keys
        a, z = lo + q_offset + 1, full - 1 + q_offset + 1
        total += (a + z) * (full - lo) // 2
    return total + (sq - full) * skv


def attention_bound(
    *,
    batch: int,
    sq: int,
    skv: int,
    hq: int,
    hkv: int,
    d: int,
    causal: bool = True,
    q_offset: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    hw: HardwareSpec | None = None,
    dv: int | None = None,
    shared_k: int = 0,
) -> SU3Roofline:
    """Bound of one attention call: q, k (head dim D), v and o (Dv; None:
    D) read and written once each, against 2 (D + Dv) flops (QK^T and PV, a
    multiply and an add each) for every visible (query, key) pair of every
    query head, at the peak of ``dtype`` (bf16: tensor cores; f32: CUDA
    cores).  ``shared_k`` of k's D columns are one channel that every kv
    head shares (MLA's rope part, 64, given apart): read once, not once a
    head.

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    dv = d if dv is None else dv
    word = torch.empty((), dtype=dtype).element_size()
    pairs = visible_pairs(sq, skv, causal=causal, q_offset=q_offset)
    return SU3Roofline(
        name=f"attention_b{batch}_q{sq}_k{skv}_h{hq}/{hkv}_d{d}" + ("" if dv == d else f"_dv{dv}"),
        hw=hw,
        flops=2.0 * batch * hq * (d + dv) * pairs,
        bytes=float(word * batch * (sq * hq * (d + dv)
                                    + skv * (hkv * (d - shared_k + dv) + shared_k))),
        peak_flops=hw.peak_flops_bf16 if dtype == torch.bfloat16 else hw.peak_flops_fp32,
    )


def attention_bwd_bound(
    *,
    batch: int,
    sq: int,
    skv: int,
    hq: int,
    hkv: int,
    d: int,
    causal: bool = True,
    q_offset: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    hw: HardwareSpec | None = None,
    dv: int | None = None,
    shared_k: int = 0,
) -> SU3Roofline:
    """Bound of one attention backward: q, k (head dim D), v, out, dout (Dv;
    None: D) and the f32 lse read once, dq, dk (D) and dv (Dv) written once,
    against five products per visible (query, key) pair of every query
    head: S = Q K^T recomputed, dQ = dS K and dK = dS^T Q of 2 D flops each,
    dP = dO V^T and dV = P^T dO of 2 Dv each, at the peak of ``dtype``.
    ``shared_k`` of k's D columns are one channel shared by every kv head
    (MLA's rope part): it and its gradient move once, not once a head.

    Raises:
        LookupError: when no spec is given and the card is unknown.
    """
    hw = hw if hw is not None else current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    dv = d if dv is None else dv
    word = torch.empty((), dtype=dtype).element_size()
    pairs = visible_pairs(sq, skv, causal=causal, q_offset=q_offset)
    return SU3Roofline(
        name=f"attention_bwd_b{batch}_q{sq}_k{skv}_h{hq}/{hkv}_d{d}" + (
            "" if dv == d else f"_dv{dv}"),
        hw=hw,
        flops=2.0 * batch * hq * (3 * d + 2 * dv) * pairs,
        bytes=float(word * batch * 2 * (sq * hq * (d + dv)
                                        + skv * (hkv * (d - shared_k + dv) + shared_k))
                    + 4 * batch * hq * sq),
        peak_flops=hw.peak_flops_bf16 if dtype == torch.bfloat16 else hw.peak_flops_fp32,
    )
