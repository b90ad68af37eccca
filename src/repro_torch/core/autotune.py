"""SU3 autotune for the port: the multiply's roofline-pruned pipeline sweep
and its marginal tile, k and layout sweeps, the stencil's (tile, overlap,
depth) sweep, the CG iteration's (tile, fused) sweep, and their cache.

    PYTHONPATH=src python -m repro_torch.core.autotune [--L 8] [--device cpu]

prints the multiply's sweeps and its tuned config (:func:`main`).

Port of ``repro.core.autotune``: enumerate a candidate grid, rank it with a
roofline model, MEASURE only the top ``prune`` fraction, keep the best
measured candidate and persist it, so the engine, the serving stack and
the solvers start from the tuned tuple for free.

What changed for Hopper:

  * **tile.** The CUDA kernels run a fixed 256-thread block (one thread per
    (site, link)), so ``tile`` only sets the site padding granularity (and
    the AoSoA lane width).  The tile axis of the sweep therefore measures
    padding, not blocking; at L >= 4 every tile up to L^4 pads nothing and
    the tile choice is noise.  No blocking knob is invented here.
  * **The gate.** The reference drops tiles whose working set exceeds the
    TPU's VMEM.  Here the gate is the kernel's register budget
    (:func:`repro_torch.kernels.su3_matmul.kernel_budget`): an instantiation
    that spills registers to local memory, or fits no block on an SM, gives
    no candidate.  The plain version on the CPU has no budget and no gate.
  * **The issue term.** The reference differences lowered XLA programs
    (``kernel_instruction_model``); that has no counterpart.  The issue term
    is the kernel's own FP32 operation count per site and multiply —
    22 operations per complex output entry, 36 entries (24 two-row): 792 at
    f32, each followed by a bf16 round (2 more) under pure bf16 — over the
    card's FP32 issue rate (half its FP32 flop rate: one operation per lane
    per clock, where a flop rate counts an FMA twice).
  * **The launch cost.** ``DISPATCH_ISSUE_SLOTS`` becomes
    :data:`LAUNCH_OVERHEAD_S`, seconds per launch, amortized over the chain.
  * **The cache.** Its own environment variable and directory (inside the
    checkout by default), and a device identity of the torch and CUDA
    versions, the card's name and its SM count.
  * **The layout sweep.** There is no compiled HLO to count: the bytes of
    a plain torch variant are counted op by op
    (:func:`counted_bytes_for_variant`), and the bound is the card's HBM
    rate, not the TPU's.

The stencil and CG tuners follow the same pattern, on the plan's slabs:

  * **The gate** is the stencil or CG kernel's register budget
    (:func:`repro_torch.kernels.su3_stencil.kernel_budget`), where the
    reference has the stencil's and CG body's VMEM working sets.
  * **The issue term** is each kernel's own FP32 operation count per site
    (:func:`stencil_ops_per_site`), where the reference lowers the Pallas
    kernel and counts the instructions of its HLO.
  * **The bytes** of the stencil are those of
    :func:`repro_torch.core.roofline.stencil_bound`, of one CG iteration
    those of :func:`repro_torch.core.roofline.cg_iteration_bound`.
  * **The slabs** are real: ``hosts`` slabs of one tensor on one card, so a
    candidate is measured on a ``hosts``-slab plan, overlapped schedules
    included.  The model is of that card: the exchange is a copy of the
    ghost faces in device memory on a side stream, hidden under the
    interior pass when it is shorter; the serial path reads every
    neighbour in place and pays no exchange (see :func:`predict_stencil`).
  * **Ranks.** Under a process group the candidates run on the ranked plan
    (``MeshSpec.resolve`` gives it), every rank taking part: a candidate's
    seconds are the slowest rank's and its ``verified`` the AND over the
    ranks (one all-reduce), so every rank ranks the same rows and returns
    the same config.  Rank 0 alone reads the cache (and tells the others
    hit or miss) and writes it, under a key that carries the world size.
    The model then charges each rank its share of the lattice, the ghost
    bytes that leave the rank at the card's peer rate
    (``HardwareSpec.peer_bw``) and, for CG, the reductions
    (:data:`CG_REDUCTION_LATENCY_S`).

Cache location: ``$REPRO_TORCH_SU3_CACHE_DIR`` or ``build/repro_torch/autotune``
at the root of the checkout.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import roofline
from repro_torch.core.su3 import layouts
from repro_torch.core.su3 import registry as su3_registry
from repro_torch.core.su3.engine import SU3Engine
from repro_torch.core.su3.layouts import Layout
from repro_torch.core.su3.plan import (EngineConfig, build_plan, cli_device, make_raw_step,
                                       resolve_device, verify_tolerance)
from repro_torch.distributed import sharding as dist_sharding
from repro_torch.kernels import su3_matmul, su3_stencil
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec

CACHE_ENV = "REPRO_TORCH_SU3_CACHE_DIR"
CACHE_FILE = "su3_autotune.json"
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "autotune"
SCHEMA_VERSION = 2  # the port's own schema (2: ranked keys); reference entries never share a file
DEFAULT_PRUNE = 0.5  # measure the top half of the model-ranked candidates
DEFAULT_TILES = (128, 256, 512, 1024, 2048, 4096)
DEFAULT_KS = (1, 2, 4, 8)
# Cost of one kernel launch through the ctypes wrapper, amortized over the
# fused chain: chip_smoke.py's "launch_cost_us" (a 1-slot, 256-site
# megakernel launch, back to back) measured 33 us per launch on the host
# clock and 32 us between events on an H100 80GB HBM3 at 700 W — the
# wrapper's host work, not the card, sets it.
LAUNCH_OVERHEAD_S = 33e-6
# FP32 operations per complex output entry of one multiply: 3 complex
# products (4 multiplies, 2 adds each, of which the first pair are the
# initial sum) folded in _mult_tile's order = 6 + 8 + 8
OPS_PER_ENTRY = 22
# under pure bf16 every operation is followed by a round to bf16 and back
BF16_ROUND_OPS = 2
DEFAULT_DEPTHS = (1, 2)  # halo exchange depths the stencil sweep considers
# FP32 operations of the stencil kernel per site: per colour k and (mu, l)
# a forward and a backward complex product (2 multiplies and 1 add each,
# per part) and 2 + 2 accumulating adds; each colour's sum starts from its
# first term: 3 x (12 x 16 - 2)
STENCIL_OPS_PER_SITE = 3 * (12 * 16 - 2)
# two-row links: row 2 rebuilt per link, 3 entries of 2 parts x (4
# multiplies + 3 adds), in f32 (narrowed after, under pure bf16)
REBUILD_OPS_PER_SITE = 4 * 3 * 2 * 7
# the fused CG body's p' = r + beta p at the centre and the 8 neighbours
CG_AXPY_OPS_PER_SITE = 9 * 6 * 2
# Fixed cost of one ghost exchange of the multi-slab schedules on the card:
# chip_smoke.py's "multislab times" row measured the exchange of PAPER_L32
# on 2 slabs (two index_selects of 131,072 sites) at 0.01835 ms between
# CUDA events, of which 12.6 MB at the HBM rate are 0.00376 ms; the rest,
# 1.459e-5 s (1.466e-5 on 4 slabs), is this constant (an H100 80GB HBM3 at
# 700 W).  A run on another machine gave 2.436e-5: it is launch cost, and
# moves with the host.  The exchange's bytes are charged on top at the HBM
# rate.
HALO_EXCHANGE_LATENCY_S = 1.459e-5
# Fixed cost of the two reductions of one CG iteration on a ranked plan
# (each an all-gather of the ranks' partial sums, added in rank order):
# chip_smoke.py's "ranked CG reductions" row timed rr + dot of a small field
# on one NCCL rank at 0.7787 / 0.6822 ms (host clock to a synchronize,
# medians of 50) against 0.0370 / 0.0416 ms on the one-process plan, a
# difference of 0.6912 ms, on an H100 80GB HBM3 at 700 W.  A run on another
# machine gave 0.2522: it is the host's cost of the two collectives, not
# their 8 bytes, and moves with the host.
CG_REDUCTION_LATENCY_S = 6.912e-4


# ---------------------------------------------------------------------------
# Roofline-pruned pipeline sweep: rank the (tile, fused_k) grid with the
# three-term model, measure only the top fraction.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineCandidate:
    """One point of the joint (tile, fused chain depth) grid."""

    tile: int
    fused_k: int


def _budget(dtype: str, accum_dtype: str, compression: str) -> dict[str, Any]:
    """The multiply kernel's per-block budget for these dtypes (on the
    current CUDA device)."""
    return su3_matmul.kernel_budget(
        torch.float32 if dtype == "float32" else torch.bfloat16,
        accum_dtype or None, compression == "two_row",
    )


def _budget_fits(dtype: str, accum_dtype: str, compression: str) -> bool:
    """The register gate: the kernel instantiation spills nothing and fits
    at least one block per SM (on the current CUDA device)."""
    budget = _budget(dtype, accum_dtype, compression)
    return budget["local_bytes"] == 0 and budget["blocks_per_sm"] >= 1


def enumerate_candidates(
    tiles: tuple[int, ...] = DEFAULT_TILES,
    ks: tuple[int, ...] = DEFAULT_KS,
    dtype: str = "float32",
    accum_dtype: str = "",
    compression: str = "none",
    device: torch.device | str | None = None,
) -> list[PipelineCandidate]:
    """The (tile, fused_k) grid the pruner ranks.  On the card it is empty
    when the kernel for these dtypes spills registers or fits no block (the
    counterpart of the reference's VMEM gate); the CPU's plain version has
    no such budget."""
    if resolve_device(device).type == "cuda" and not _budget_fits(dtype, accum_dtype, compression):
        return []
    return [PipelineCandidate(tile, k) for tile in tiles for k in ks]


def ops_per_site(dtype: str = "float32", accum_dtype: str = "",
                 compression: str = "none") -> int:
    """FP32 operations the CUDA kernel issues per site and multiply: 792 at
    f32 (528 two-row, which computes the stored rows only), three times that
    under pure bf16 (a round to bf16 and back after every operation)."""
    rows = 2 if compression == "two_row" else layouts.SU3
    ops = OPS_PER_ENTRY * layouts.LINKS * rows * layouts.SU3
    if dtype == "bfloat16" and accum_dtype != "float32":
        ops *= 1 + BF16_ROUND_OPS
    return ops


def predict_pipeline(
    cand: PipelineCandidate,
    L: int,
    dtype: str = "float32",
    accum_dtype: str = "",
    hw: roofline.HardwareSpec | None = None,
    compression: str = "none",
) -> dict[str, Any]:
    """Three-term per-multiply prediction for one candidate.

    memory_s amortizes the one HBM read + write over the fused chain,
    compute_s is the FP32 flop roof, and issue_s charges the kernel's FP32
    operations at the card's issue rate plus the launch cost amortized over
    the chain; the largest is the predicted bound.  Every term charges the
    PADDED sites (what the kernel runs); the predicted rate credits only the
    useful flops, so an oversized tile at small L ranks as it measures.

    Raises:
        LookupError: when no ``hw`` is given and the card is unknown.
    """
    hw = hw if hw is not None else roofline.current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    n_sites = L**4
    padded = ((n_sites + cand.tile - 1) // cand.tile) * cand.tile
    k = cand.fused_k
    tm = layouts.TrafficModel.for_dtype(
        Layout.SOA, padded, dtype, compression=layouts.GaugeCompression(compression),
    )
    compute_s = float(tm.flops_per_site) * padded / hw.peak_flops_fp32
    memory_s = tm.total_bytes / k / hw.hbm_bw
    issue_rate = hw.peak_flops_fp32 / 2  # one FP32 operation per lane per clock
    issue_s = (float(ops_per_site(dtype, accum_dtype, compression)) * padded / issue_rate
               + LAUNCH_OVERHEAD_S / k)
    bound_s = max(compute_s, memory_s, issue_s)
    terms = {"compute": compute_s, "memory": memory_s, "issue": issue_s}
    useful_flops = float(tm.flops_per_site) * n_sites  # per multiply
    return {
        "tile": cand.tile,
        "fused_k": k,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "issue_s": issue_s,
        "bound_s": bound_s,
        "dominant": max(terms, key=terms.get),
        "predicted_gflops": round(useful_flops / bound_s / 1e9, 3),
    }


def measure_candidate(
    cand: PipelineCandidate, L: int = 8, dtype: str = "float32",
    accum_dtype: str = "", compression: str = "none",
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Measured per-multiply GFLOPS of one (tile, fused_k) candidate — the
    fused chain run exactly as it deploys (``SU3Engine.run_fused``)."""
    cfg = EngineConfig(
        L=L, dtype=dtype, variant="cuda", layout=Layout.SOA,
        tile=cand.tile, accum_dtype=accum_dtype, iterations=2, warmups=1,
        compression=compression,
    )
    r = SU3Engine(cfg, device).run_fused(k=cand.fused_k, reps=2)
    return {
        "tile": cand.tile,
        "fused_k": cand.fused_k,
        "measured_gflops": round(r.gflops, 3),
        "verified": r.verified,
    }


def pipeline_sweep(
    L: int = 8,
    dtype: str = "float32",
    accum_dtype: str = "",
    *,
    compression: str = "none",
    prune: float = DEFAULT_PRUNE,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    ks: tuple[int, ...] = DEFAULT_KS,
    measure_fn: Callable[[PipelineCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Rank the candidate grid with the model; measure the top slice.

    Args:
        prune: fraction of the model-ranked candidate set to measure
            (``>= 1`` = exhaustive; the default measures half).  At least
            one candidate is always measured.
        measure_fn: measurement override (tests inject deterministic
            measurements; production uses :func:`measure_candidate`).
        hw: the card's spec; defaults to CUDA device 0's.
        device: where the candidates are measured (``None`` = the card).

    Returns:
        ``{"rows", "candidates_total", "candidates_measured", "prune"}`` —
        each row carries the model prediction (compute/memory/issue seconds,
        predicted GFLOPS, ``predicted_rank``) joined with the measurement.
    """
    cands = enumerate_candidates(tiles, ks, dtype, accum_dtype, compression, device)
    if not cands:
        raise RuntimeError("no pipeline candidate fits the kernel's register budget")
    preds = [predict_pipeline(c, L, dtype, accum_dtype, hw, compression=compression)
             for c in cands]
    if measure_fn is None:
        measure_fn = lambda c: measure_candidate(  # noqa: E731
            c, L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
            device=device,
        )
    return _ranked_sweep(cands, preds, prune, measure_fn)


def _ranked_sweep(cands: list, preds: list[dict[str, Any]], prune: float,
                  measure_fn: Callable[[Any], dict[str, Any]]) -> dict[str, Any]:
    """Measure the top ``prune`` fraction of ``cands`` by predicted GFLOPS
    (at least one); each row joins the prediction, the measurement and the
    candidate's predicted rank."""
    order = sorted(range(len(cands)), key=lambda i: -preds[i]["predicted_gflops"])
    n_meas = len(cands) if prune >= 1 else max(1, math.ceil(prune * len(cands)))
    rows = []
    for rank, i in enumerate(order[:n_meas]):
        row = dict(preds[i])
        row.update(measure_fn(cands[i]))
        row["predicted_rank"] = rank
        rows.append(row)
    return {"rows": rows, "candidates_total": len(cands), "candidates_measured": n_meas,
            "prune": prune}


# ---------------------------------------------------------------------------
# Marginal sweeps: one axis at a time, exhaustive, for the CLI and diagnosis
# (production tuning goes through the pruned joint pipeline_sweep)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuneResult:
    """The tuned multiply as the CLI reports it: the winning ``config``
    with its measured GFLOPS, its bytes per site as counted
    (:func:`counted_bytes_for_variant`) and as modelled
    (``TrafficModel``), the kernel's register ``budget`` on the card
    (None on the CPU), and ``bound_gf``, the card's HBM-bound GFLOPS at the
    config's arithmetic intensity.  The reference's HLO bytes, VMEM bytes
    and TPU bound stand where the counted bytes, the budget and the card's
    bound stand here."""

    config: dict[str, Any]
    measured_gflops: float
    counted_bytes_per_site: float
    model_bytes_per_site: float
    budget: dict[str, Any] | None
    bound_gf: float


def _engine_config(L: int, dtype: str, tile: int, accum_dtype: str) -> EngineConfig:
    return EngineConfig(L=L, dtype=dtype, variant="cuda", layout=Layout.SOA, tile=tile,
                        accum_dtype=accum_dtype, iterations=2, warmups=1)


def tile_sweep(
    tiles: tuple[int, ...] = DEFAULT_TILES,
    L: int = 8,
    dtype: str = "float32",
    accum_dtype: str = "",
    device: torch.device | str | None = None,
) -> list[dict]:
    """Site padding, the register budget and the measured engine time per
    tile, at k=1.

    ``tile`` sets only the padding (and the AoSoA lane): the kernel's block
    is fixed, so each row reports the sites the kernel runs, the padded
    ones among them, and the one kernel's budget (registers, spill, blocks
    per SM; ``fits_budget`` is the pipeline's gate), where the reference
    reports each tile's VMEM working set against the TPU's.  On the CPU the
    plain version has no budget: its fields are None.
    """
    dev = resolve_device(device)
    gate: dict[str, Any] = dict.fromkeys(("num_regs", "local_bytes", "blocks_per_sm",
                                          "fits_budget"))
    if dev.type == "cuda":
        b = _budget(dtype, accum_dtype, "none")
        gate = {"num_regs": b["num_regs"], "local_bytes": b["local_bytes"],
                "blocks_per_sm": b["blocks_per_sm"],
                "fits_budget": b["local_bytes"] == 0 and b["blocks_per_sm"] >= 1}
    rows = []
    for tile in tiles:
        r = SU3Engine(_engine_config(L, dtype, tile, accum_dtype), dev).run()
        padded = -(-L**4 // tile) * tile
        rows.append({"tile": tile, "padded_sites": padded, "pad_sites": padded - L**4, **gate,
                     "measured_gflops": round(r.gflops, 3), "verified": r.verified})
    return rows


def k_sweep(
    ks: tuple[int, ...] = DEFAULT_KS,
    L: int = 8,
    dtype: str = "float32",
    tile: int = 512,
    accum_dtype: str = "",
    device: torch.device | str | None = None,
) -> list[dict]:
    """Measured per-multiply GFLOPS of the fused chain at each depth K.

    The fused step amortizes one launch and one HBM round trip over K
    multiplies; where the knee lies depends on the device and L, so it is
    measured, and ``best_config`` keeps the winner beside the tile.
    """
    dev = resolve_device(device)
    rows = []
    for k in ks:
        r = SU3Engine(_engine_config(L, dtype, tile, accum_dtype), dev).run_fused(k=k, reps=2)
        rows.append({"k": k, "measured_gflops": round(r.gflops, 3), "verified": r.verified})
    return rows


LAYOUT_ROWS = (  # (variant, layout, dtype, accum_dtype, compression)
    ("versionX", Layout.AOS, "float32", "", "none"),
    ("versionX", Layout.SOA, "float32", "", "none"),
    ("version_gemm", Layout.SOA, "float32", "", "none"),
    ("cuda", Layout.SOA, "float32", "", "none"),
    ("cuda", Layout.SOA, "bfloat16", "float32", "none"),
    ("cuda", Layout.SOA, "float32", "", "two_row"),
    ("cuda", Layout.SOA, "bfloat16", "float32", "two_row"),
)


def counted_bytes_for_variant(
    variant: str,
    layout: Layout,
    n_sites: int = 4096,
    tile: int = 512,
    dtype: str = "float32",
    accum_dtype: str = "",
    compression: str = "none",
) -> float:
    """Bytes per site of one physical plan step, counted on the CPU.

    A variant that runs plain torch ops (``versionX``, ``version_gemm``:
    the codec's unpack, the multiply, the pack) is run once on packed zero
    operands under the dry run's op byte counter
    (:func:`repro_torch.launch.dryrun.op_bytes`): every aten op's operands
    and results, the eager path's traffic with no fusion.  A CUDA variant
    keeps a site's product in registers, so its count is that of its one
    launch's operands: the packed A read and C written once each, at their
    padded size and storage width, and B read once; its plain version's
    ops, which run on the CPU, are not counted.  The reference lowers
    each step through XLA and counts HLO bytes instead.
    """
    codec = layouts.make_codec(layout, tile=tile, dtype=dtype, accum_dtype=accum_dtype,
                               compression=layouts.GaugeCompression(compression))
    padded = n_sites + (-n_sites) % tile
    a_phys = codec.pack(torch.zeros((padded, 4, 3, 3), dtype=torch.complex64)).contiguous()
    b_p = codec.pack_b(torch.zeros((4, 3, 3), dtype=torch.complex64))
    entry = su3_registry.get_kernel(variant)
    if entry.form == su3_registry.PLANAR:
        moved = 2 * a_phys.numel() * a_phys.element_size() + b_p.numel() * b_p.element_size()
    else:
        step = make_raw_step(codec, entry, tile=tile)
        moved = dryrun.op_bytes(lambda: step(a_phys, b_p))
    return moved / padded


def layout_sweep(n_sites: int = 4096, hw: roofline.HardwareSpec = roofline.H100_SXM) -> list[dict]:
    """The paper's AoS -> SoA traffic claim, counted per variant.

    Each row has the ``TrafficModel``'s bytes per site (read A, write C),
    the bytes counted by :func:`counted_bytes_for_variant` (the eager ops'
    traffic for a plain torch variant; for a CUDA variant its launch's
    operands, A and C once and B once, not a measurement of the kernel),
    the arithmetic intensity, and ``hbm_bound_gf``, the rate ``hw``'s HBM
    allows at that intensity (the H100 SXM's by default).  The bf16-storage
    / f32-accumulate and the two-row rows stream 2-byte and 48-word sites.
    """
    rows = []
    for variant, layout, dtype, accum, comp in LAYOUT_ROWS:
        tm = layouts.TrafficModel.for_dtype(layout, n_sites, dtype,
                                            compression=layouts.GaugeCompression(comp))
        counted = counted_bytes_for_variant(variant, layout, n_sites, dtype=dtype,
                                            accum_dtype=accum, compression=comp)
        rows.append({
            "variant": variant, "layout": layout.value, "dtype": dtype,
            "accum_dtype": accum or dtype, "compression": comp,
            "model_bytes_per_site": tm.bytes_per_site_rw,
            "counted_bytes_per_site": round(counted, 1),
            "counted_by": ("kernel operands"
                           if su3_registry.get_kernel(variant).form == su3_registry.PLANAR
                           else "aten ops"),
            "ai": round(tm.arithmetic_intensity, 3),
            "hbm_bound_gf": round(hw.hbm_bw * tm.arithmetic_intensity / 1e9, 1),
            "hw": hw.name,
        })
    return rows


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


def cache_dir() -> str:
    """``$REPRO_TORCH_SU3_CACHE_DIR``, else ``build/repro_torch/autotune``
    at the root of the checkout."""
    return os.environ.get(CACHE_ENV, str(DEFAULT_CACHE_DIR))


def cache_key(
    *,
    backend: str,
    device_kind: str,
    layout: str,
    dtype: str,
    L: int,
    n_devices: int,
    compression: str = "none",
    world: int | None = None,
    schema: int = SCHEMA_VERSION,
) -> str:
    """Versioned cache key: a ``v{schema}`` prefix, so entries of another
    schema never match, ``compression`` as its own segment, so an 18-real
    and a two-row decision for the same (dtype, L) never alias, and, for a
    decision measured on the ranks of a process group, their number
    (``w{world}``)."""
    ranks = "" if world is None else f"|w{world}"
    return (
        f"v{schema}|{backend}|{device_kind}|{layout}|{dtype}"
        f"|{compression}{ranks}|L{L}|d{n_devices}"
    )


def _cache_path(directory: str | None) -> str:
    return os.path.join(directory or cache_dir(), CACHE_FILE)


def load_cache(directory: str | None = None) -> dict[str, Any]:
    path = _cache_path(directory)
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def _group() -> tuple[Any, int, int]:
    """``(group, rank, world)`` of the running process group, ``(None, 0,
    1)`` without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def _cache_hit(key: str, valid: Callable[[Any], dict[str, Any] | None], cache: bool,
               refresh: bool, directory: str | None) -> dict[str, Any] | None:
    """The cached config under ``key`` (``cached=True``), or None to
    measure.  Under a process group rank 0 alone reads the file and
    broadcasts what it found, so either every rank sweeps or none does."""
    group, rank, world = _group()
    hit = valid(load_cache(directory).get(key)) if cache and not refresh and rank == 0 else None
    if world > 1:
        box = [hit]
        torch.distributed.broadcast_object_list(box, src=0, group=group)
        hit = box[0]
    return None if hit is None else dict(hit, cached=True)


def _ranks_agree(seconds: float, verified: bool, device: torch.device) -> tuple[float, bool]:
    """Under a process group, the slowest rank's ``seconds`` and the AND
    of the ranks' ``verified``, from one all-reduce (the MAX of
    ``[seconds, failed]``); without one, both as given."""
    group = _group()[0]
    if group is None:
        return seconds, verified
    t = torch.tensor([seconds, 0.0 if verified else 1.0], dtype=torch.float64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=group)
    return float(t[0]), float(t[1]) == 0.0


def _check_hosts(hosts: int) -> None:
    """Refuse, before any measurement, slabs that do not divide over the
    running group's ranks."""
    world = _group()[2]
    if hosts % world:
        raise ValueError(f"hosts={hosts} is not a multiple of the world's {world} ranks: "
                         f"every rank owns whole slabs")


def _fits_ranks(tile: int, L: int, hosts: int) -> bool:
    """A ranked plan of ``hosts`` slabs pads nothing (``build_plan``
    refuses padding on several ranks): the tile must divide each slab's
    sites.  Without a group every tile fits."""
    world = _group()[2]
    return world == 1 or (L**4) % (hosts * tile) == 0


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """The bitwise check of a measured candidate against its oracle."""
    return torch.equal(x, y)


def store_cache_entry(
    key: str, entry: dict[str, Any], directory: str | None = None
) -> None:
    """Read-modify-write the cache file via an atomic rename."""
    path = _cache_path(directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cache = load_cache(directory)
    cache[key] = entry
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _device_identity(device: torch.device | str | None = None) -> tuple[str, str, int]:
    """``(backend, device_kind, n_devices)`` of the measuring device: the
    kind names the torch and CUDA versions, the card's name and its SM
    count (the CPU's kind names torch only)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        kind = (f"{props.name}|sm{props.multi_processor_count}"
                f"|torch{torch.__version__}|cuda{torch.version.cuda}")
        return "cuda", kind, 1
    return dev.type, f"torch{torch.__version__}", 1


# ---------------------------------------------------------------------------
# The tuned production config
# ---------------------------------------------------------------------------


# keys a cached config must carry to be served without re-measuring; an
# entry truncated by a crashed writer falls through to a fresh sweep
_REQUIRED_CONFIG_KEYS = frozenset(
    {"layout", "variant", "tile", "fused_k", "compression", "pipeline"}
)


def _valid_cache_hit(hit: Any) -> dict[str, Any] | None:
    """The cached config dict iff the entry is structurally sound."""
    if not isinstance(hit, dict):
        return None
    config = hit.get("config")
    if not isinstance(config, dict) or not _REQUIRED_CONFIG_KEYS <= config.keys():
        return None
    return config


def best_config(
    L: int = 8,
    dtype: str = "float32",
    *,
    accum_dtype: str = "",
    compression: str = "none",
    cache: bool = True,
    cache_directory: str | None = None,
    refresh: bool = False,
    prune: float = DEFAULT_PRUNE,
    measure_fn: Callable[[PipelineCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """The tuned production config: SoA + the (tile, fused_k) pipeline point
    with the best MEASURED GFLOPS among the model-ranked top candidates.

    Selection is by measured throughput among verified candidates; the
    model only decides what is worth timing.  The decision is persisted
    with its ``pipeline`` provenance (schema, candidate counts, the winner's
    predicted rank); a later call with the same key measures nothing.
    Corrupt or partial entries are misses and re-measure.  ``accum_dtype``
    and ``compression`` tune those plans as deployed, under their own keys.

    Raises:
        RuntimeError: no candidate fits, or none of the measured verified.
    """
    key = _keyed("soa", L, dtype, accum_dtype, compression, device)
    hit = _cache_hit(key, _valid_cache_hit, cache, refresh, cache_directory)
    if hit is not None:
        return hit

    sweep = pipeline_sweep(
        L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
        prune=prune, measure_fn=measure_fn, hw=hw, device=device,
    )

    def config(w: dict) -> dict:
        return {
            "layout": "soa", "variant": "cuda",
            "tile": w["tile"], "fused_k": w["fused_k"],
            "compression": compression,
            "pipeline": {
                "schema": SCHEMA_VERSION,
                "prune": sweep["prune"],
                "candidates_total": sweep["candidates_total"],
                "candidates_measured": sweep["candidates_measured"],
                "predicted_gflops": w.get("predicted_gflops", 0.0),
                "predicted_rank": w.get("predicted_rank", 0),
            },
        }

    return _tuned(key, sweep, lambda rows: max(rows, key=lambda r: r["measured_gflops"]),
                  config, cache, cache_directory)


def _keyed(layout: str, L: int, dtype: str, accum_dtype: str, compression: str,
           device: torch.device | str | None, world: int | None = None) -> str:
    """The cache key of a tuned decision on the measuring device (measured
    by the ``world`` ranks of a process group, when given)."""
    backend, device_kind, n_devices = _device_identity(device)
    dtype_key = f"{dtype}+acc-{accum_dtype}" if accum_dtype else dtype
    return cache_key(backend=backend, device_kind=device_kind, layout=layout,
                     dtype=dtype_key, L=L, n_devices=n_devices, compression=compression,
                     world=world)


def _tuned(key: str, sweep: dict[str, Any], pick: Callable[[list[dict]], dict],
           config: Callable[[dict], dict], cache: bool,
           cache_directory: str | None) -> dict[str, Any]:
    """Pick the winner among a sweep's verified rows and persist its
    config (with its measured GFLOPS) under ``key``: rank 0 alone writes
    under a process group, and every rank passes a barrier after it."""
    rows = [r for r in sweep["rows"] if r["verified"]]
    if not rows:
        raise RuntimeError("no verified candidate in the measured set")
    winner = pick(rows)
    cfg = config(winner)
    group, rank, world = _group()
    if cache and rank == 0:
        store_cache_entry(
            key, {"config": cfg, "measured_gflops": winner["measured_gflops"], "key": key},
            cache_directory,
        )
    if world > 1:
        torch.distributed.barrier(group=group)
    return dict(cfg, cached=False)


def tuned_engine_config(
    L: int = 8, dtype: str = "float32", *, cache_directory: str | None = None,
    device: torch.device | str | None = None, **overrides: Any,
) -> EngineConfig:
    """EngineConfig built from the (cached) tuned tuple, override-able.

    An ``accum_dtype`` or ``compression`` override also steers the tuning
    itself (such plans are measured as deployed, under their own cache key).
    """
    tuned = best_config(
        L=L, dtype=dtype, accum_dtype=overrides.get("accum_dtype", ""),
        compression=overrides.get("compression", "none"),
        cache_directory=cache_directory, device=device,
    )
    base = {
        "L": L, "dtype": dtype, "layout": layouts.Layout(tuned["layout"]),
        "variant": tuned["variant"], "tile": tuned["tile"],
        "compression": tuned.get("compression", "none"),
    }
    base.update(overrides)
    return EngineConfig(**base)


def tuned_fused_k(
    L: int = 8, dtype: str = "float32", *, accum_dtype: str = "",
    compression: str = "none", cache_directory: str | None = None,
    device: torch.device | str | None = None,
) -> int:
    """The measured-best fused chain depth for (device, L), from the cache;
    the first call per device identity pays the sweep."""
    return int(best_config(L=L, dtype=dtype, accum_dtype=accum_dtype,
                           compression=compression, cache_directory=cache_directory,
                           device=device)["fused_k"])


def _cg_measure_problem(L: int, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic convergent CG problem: a constant-per-direction SU(3)
    gauge field (each U_mu constant along mu, so the site-local-adjoint
    stencil is exactly Hermitian) and a unit-scale right-hand side.

    Built with numpy from ``seed`` exactly as the reference builds it, so
    both packages can consume the same arrays.

    Returns:
        ``(u, b)``: ``u`` (L^4, 4, 3, 3) and ``b`` (L^4, 3), complex64.
    """
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 3, 3)) + 1j * rng.normal(size=(4, 3, 3))
    q, r = np.linalg.qr(a)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)
    n = L**4
    u = np.broadcast_to(q, (n, 4, 3, 3)).astype(np.complex64)
    b = (rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))).astype(np.complex64)
    return u, b


# ---------------------------------------------------------------------------
# The stencil sweep: rank (tile, overlap, depth) with a model whose
# bandwidth term includes the exchange, measure the top fraction.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StencilCandidate:
    """One point of the stencil grid: the site tile x whether the
    exchange / interior / boundary schedule runs x the exchange depth (a
    depth-2 exchange feeds two applications and recomputes the ring)."""

    tile: int
    overlap: bool
    depth: int = 1


def _stencil_budget_fits(kernel: str, dtype: str, accum_dtype: str, compression: str) -> bool:
    """The register gate of the stencil (or CG) kernel for these dtypes:
    nothing spilled and at least one block per SM."""
    budget = su3_stencil.kernel_budget(
        kernel, torch.float32 if dtype == "float32" else torch.bfloat16,
        accum_dtype or None, compression == "two_row",
    )
    return budget["local_bytes"] == 0 and budget["blocks_per_sm"] >= 1


def enumerate_stencil_candidates(
    tiles: tuple[int, ...] = DEFAULT_TILES,
    overlaps: tuple[bool, ...] = (False, True),
    dtype: str = "float32",
    accum_dtype: str = "",
    compression: str = "none",
    device: torch.device | str | None = None,
    depths: tuple[int, ...] = DEFAULT_DEPTHS,
) -> list[StencilCandidate]:
    """The (tile, overlap, depth) grid the stencil pruner ranks; empty on
    the card when the stencil kernel for these dtypes fails its register
    gate.  Depth 2 exists only on the overlap schedule (the ring is built
    from it), so (overlap=False, depth=2) is never a candidate."""
    if resolve_device(device).type == "cuda" and not _stencil_budget_fits(
            "stencil", dtype, accum_dtype, compression):
        return []
    return [StencilCandidate(tile, ov, d) for tile in tiles for ov in overlaps
            for d in depths if ov or d == 1]


def stencil_ops_per_site(dtype: str = "float32", accum_dtype: str = "",
                         compression: str = "none", cg: bool = False) -> int:
    """FP32 operations the stencil kernel (``cg=True``: the fused CG body)
    issues per site: 570 (678 with the CG axpys), three times that under
    pure bf16 (a round to bf16 and back after every operation), plus the
    two-row rebuild of row 2 (168, and 2 rounds per rebuilt entry under
    pure bf16)."""
    pure = dtype == "bfloat16" and accum_dtype != "float32"
    ops = STENCIL_OPS_PER_SITE + (CG_AXPY_OPS_PER_SITE if cg else 0)
    if pure:
        ops *= 1 + BF16_ROUND_OPS
        if cg:
            ops += BF16_ROUND_OPS  # beta
    if compression == "two_row":
        ops += REBUILD_OPS_PER_SITE + (4 * 3 * 2 * BF16_ROUND_OPS if pure else 0)
    return ops


def _stencil_halo_spec(L: int, hosts: int, word_bytes: int,
                       depth: int = 1) -> dist_sharding.HaloSpec:
    """Vector-field HaloSpec for ``hosts`` slabs (no halo on one)."""
    return dist_sharding.HaloSpec(
        L=L, n_shards=max(hosts, 1), word_bytes=word_bytes,
        words_per_site=dist_sharding.VECTOR_WORDS_PER_SITE, depth=depth,
    )


def _exchange_bytes(halo: dist_sharding.HaloSpec, hosts: int, fields: int,
                    depth: int) -> int:
    """Bytes one exchange moves on the card: the +-t ghosts of every
    boundary site of every slab (and, at depth 2, the ring's 8-direction
    neighbourhoods, 8 values per ghost), for each exchanged field, each
    value read and written once."""
    ghosts = 2 * hosts * halo.boundary_sites
    values = ghosts * (1 if depth == 1 else 1 + 8)
    return 2 * fields * values * halo.words_per_site * halo.word_bytes


def _exchange_seconds(exchange_bytes: int, hw: roofline.HardwareSpec) -> float:
    return HALO_EXCHANGE_LATENCY_S + exchange_bytes / hw.hbm_bw


def _ranked_world(world: int | None) -> int | None:
    """The ranks a prediction is for: ``world`` as given, else the running
    group's size (None without a group: the one-process plan)."""
    if world is not None:
        return world
    group, _, size = _group()
    return None if group is None else size


def _ranked_exchange(exchange_bytes: int, ghosts: int, link_bytes: int, hosts: int,
                     world: int, hw: roofline.HardwareSpec) -> dict[str, float]:
    """One rank's share of an exchange on ``world`` ranks of ``hosts``
    slabs: of the ``2 * hosts`` face transfers the ``2 * world`` at the
    ranks' boundaries cross (none on one rank).  The crossing ghosts' bytes
    (one copy each way; at depth 2 also the links of the ring sites another
    rank owns, ``link_bytes`` per ghost) go at ``peer_bw`` a direction, the
    rest of the exchange's on-card bytes at ``hbm_bw``; each rank moves
    ``1 / world`` of both."""
    cross = world / hosts if world > 1 else 0.0
    card_bytes = (1.0 - cross) * exchange_bytes / world
    peer_bytes = cross * (exchange_bytes / 2 + ghosts * link_bytes) / world
    return {"card_bytes": card_bytes, "peer_bytes": peer_bytes,
            "seconds": (HALO_EXCHANGE_LATENCY_S + card_bytes / hw.hbm_bw
                        + peer_bytes / hw.peer_bw)}


def predict_stencil(
    cand: StencilCandidate,
    L: int,
    dtype: str = "float32",
    accum_dtype: str = "",
    hosts: int = 1,
    hw: roofline.HardwareSpec | None = None,
    compression: str = "none",
    world: int | None = None,
) -> dict[str, Any]:
    """Roofline prediction of one stencil application under ``cand`` on a
    ``hosts``-slab plan on one card, or on the ranks of a process group.

    Every quantity is per application, so depth-1 and depth-2 rows compare
    directly.  The core terms are the kernel's: compute (576 flops/site at
    the FP32 rate), memory (:func:`roofline.stencil_bound`'s bytes), issue
    (:func:`stencil_ops_per_site` over the padded sites at the FP32 issue
    rate, plus :data:`LAUNCH_OVERHEAD_S` per kernel launch: 1 serial, 2 per
    split application, 5 per depth-2 pair).  The halo term is the
    exchange: its bytes (:func:`_exchange_bytes`) at the HBM rate plus
    :data:`HALO_EXCHANGE_LATENCY_S`, over ``depth`` applications.

    Schedules, on one card, where every slab runs in one launch:

    * serial (or one slab): the periodic gather reads every neighbour in
      place; no exchange: ``bound = core``;
    * split (``overlap`` on several slabs): the exchange runs on a side
      stream under the interior pass, then the boundary sites (a share
      ``boundary_fraction`` of every slab) are recomputed, ``depth`` times
      per application at depth 2 counting the ring:
      ``bound = max(core, halo) + depth * boundary_fraction * core``.

    On ``world`` ranks (default: the running group's; none without one)
    each rank runs its ``1 / world`` of the sites, and the exchange is
    :func:`_ranked_exchange`'s: the ghosts that cross to another rank at
    ``hw.peer_bw``, the rest at the HBM rate.  Without a group the
    prediction is the one card's above.

    Raises:
        LookupError: when no ``hw`` is given and the card is unknown.
    """
    hw = hw if hw is not None else roofline.current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    n_sites = L**4
    padded = ((n_sites + cand.tile - 1) // cand.tile) * cand.tile
    cfg = EngineConfig(L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
                       tile=cand.tile)
    kernel = roofline.stencil_bound(cfg, hw)
    world = _ranked_world(world)
    share = 1 if world is None else world  # the ranks splitting the sites
    split = cand.overlap and hosts > 1
    launches = (2.5 if cand.depth == 2 else 2.0) if split else 1.0
    issue_rate = hw.peak_flops_fp32 / 2  # one FP32 operation per lane per clock
    compute_s, memory_s = kernel.compute_s / share, kernel.memory_s / share
    issue_s = (float(stencil_ops_per_site(dtype, accum_dtype, compression)) * padded / share
               / issue_rate + LAUNCH_OVERHEAD_S * launches)
    core_s = max(compute_s, memory_s, issue_s)
    halo = _stencil_halo_spec(L, hosts, cfg.word_bytes, depth=cand.depth)
    exchange_bytes = _exchange_bytes(halo, hosts, 1, cand.depth) if split else 0
    peer_bytes = 0.0
    if not split:
        halo_s = 0.0
    elif world is None:
        halo_s = _exchange_seconds(exchange_bytes, hw) / cand.depth
    else:
        rows = layouts.make_codec(Layout.SOA, tile=cand.tile, compression=layouts.GaugeCompression(
            compression)).planar_rows
        link_bytes = 2 * rows * cfg.word_bytes if cand.depth == 2 else 0  # the ring's links
        ex = _ranked_exchange(exchange_bytes, 2 * hosts * halo.boundary_sites, link_bytes,
                              hosts, world, hw)
        halo_s, peer_bytes = ex["seconds"] / cand.depth, ex["peer_bytes"]
    boundary_frac = halo.boundary_sites / halo.sites_per_shard if hosts > 1 else 0.0
    if split:
        bound_s = max(core_s, halo_s) + cand.depth * boundary_frac * core_s
    else:
        bound_s = core_s
    terms = {"compute": compute_s, "memory": memory_s, "issue": issue_s,
             "halo": halo_s}
    return {
        "tile": cand.tile,
        "overlap": cand.overlap,
        "depth": cand.depth,
        "compression": compression,
        "hosts": hosts,
        "world": world,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "issue_s": issue_s,
        "core_s": core_s,
        "halo_s": halo_s,
        "bound_s": bound_s,
        "dominant": max(terms, key=terms.get),
        "halo_bytes_per_exchange": halo.halo_bytes_per_exchange,
        "exchange_bytes": exchange_bytes,
        "peer_bytes": peer_bytes,
        "bandwidth_bytes": kernel.bytes + exchange_bytes / cand.depth,
        "boundary_fraction": round(boundary_frac, 4),
        "predicted_gflops": round(kernel.flops / bound_s / 1e9, 3),
    }


def _best_seconds(fn: Callable[[], Any], device: torch.device, reps: int = 2) -> float:
    """Best seconds of ``fn`` over ``reps`` calls after one warm call:
    CUDA events around each call on the card, the host clock on the CPU."""
    fn()
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def measure_stencil_candidate(
    cand: StencilCandidate, L: int = 8, dtype: str = "float32",
    accum_dtype: str = "", compression: str = "none", hosts: int = 1,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Measured per-application GFLOPS of one stencil variant on a
    ``hosts``-slab plan (useful flops 576/site; a depth-d step runs d
    applications).  Verified when the step's output equals ``depth``
    serial steps bit for bit (and, at depth 1, holds the fixed point).
    Under a process group every rank runs its slabs of the ranked plan:
    the seconds are the slowest rank's and ``verified`` holds on every
    rank (:func:`_ranks_agree`), so every rank returns the same row."""
    cfg = EngineConfig(
        L=L, dtype=dtype, variant="cuda", layout=Layout.SOA, tile=cand.tile,
        accum_dtype=accum_dtype, iterations=2, warmups=1, compression=compression,
    )
    plan = build_plan(cfg, MeshSpec(hosts=hosts).resolve(device))
    step = plan.stencil_step(overlap=cand.overlap, depth=cand.depth)
    serial = plan.stencil_step(overlap=False)
    u, v = plan.init_stencil_data()
    out = step(u, v)
    want = serial(u, v) if cand.depth == 1 else serial(u, serial(u, v))
    bitwise = _same_bits(out, want)
    fixed = True if cand.depth == 2 else plan.verify_stencil(out)  # a collective on ranks
    best = _best_seconds(lambda: step(u, v), plan.device)
    best, verified = _ranks_agree(best, bitwise and fixed, plan.device)
    gf = cand.depth * su3_stencil.STENCIL_FLOPS_PER_SITE * L**4 / best / 1e9
    return {"tile": cand.tile, "overlap": cand.overlap, "depth": cand.depth,
            "measured_gflops": round(gf, 3), "verified": verified}


def stencil_sweep(
    L: int = 8,
    dtype: str = "float32",
    accum_dtype: str = "",
    *,
    hosts: int = 1,
    compression: str = "none",
    prune: float = DEFAULT_PRUNE,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    overlaps: tuple[bool, ...] = (False, True),
    depths: tuple[int, ...] = DEFAULT_DEPTHS,
    measure_fn: Callable[[StencilCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Rank the stencil grid with :func:`predict_stencil`; measure the top
    ``prune`` fraction (same return structure as :func:`pipeline_sweep`).
    On several ranks only tiles that pad no site are candidates.

    Raises:
        RuntimeError: no candidate passes the kernel's register gate.
    """
    cands = [c for c in enumerate_stencil_candidates(tiles, overlaps, dtype, accum_dtype,
                                                     compression, device, depths)
             if _fits_ranks(c.tile, L, hosts)]
    if not cands:
        raise RuntimeError("no stencil candidate fits the kernel's register budget "
                           "(and, on ranks, the slabs)")
    preds = [predict_stencil(c, L, dtype, accum_dtype, hosts, hw, compression=compression)
             for c in cands]
    if measure_fn is None:
        measure_fn = lambda c: measure_stencil_candidate(  # noqa: E731
            c, L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
            hosts=hosts, device=device,
        )
    return _ranked_sweep(cands, preds, prune, measure_fn)


def _provenance(sweep: dict[str, Any], winner: dict, hosts: int,
                compression: str) -> dict[str, Any]:
    return {
        "schema": SCHEMA_VERSION,
        "prune": sweep["prune"],
        "hosts": hosts,
        "compression": compression,
        "candidates_total": sweep["candidates_total"],
        "candidates_measured": sweep["candidates_measured"],
        "predicted_gflops": winner.get("predicted_gflops", 0.0),
        "predicted_rank": winner.get("predicted_rank", 0),
    }


# stencil entries carry (tile, overlap, depth, stencil provenance) under
# their own layout key ("soa-stencil-h{hosts}"), so they never alias the
# multiply's (tile, fused_k, pipeline)
_REQUIRED_STENCIL_KEYS = frozenset({"layout", "variant", "tile", "overlap", "depth", "stencil"})


def _valid_stencil_hit(hit: Any) -> dict[str, Any] | None:
    if not isinstance(hit, dict):
        return None
    config = hit.get("config")
    if not isinstance(config, dict) or not _REQUIRED_STENCIL_KEYS <= config.keys():
        return None
    return config


def best_stencil_config(
    L: int = 8,
    dtype: str = "float32",
    *,
    accum_dtype: str = "",
    compression: str = "none",
    hosts: int = 1,
    cache: bool = True,
    cache_directory: str | None = None,
    refresh: bool = False,
    prune: float = DEFAULT_PRUNE,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    measure_fn: Callable[[StencilCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """The tuned stencil variant for ``hosts`` slabs, persisted under the
    key layout ``soa-stencil-h{hosts}``.

    As in the reference, the TILE is decided by measurement and the
    SCHEDULE (overlap, depth) by the model among the best tile's measured
    rows: on one slab the schedules are the same program, so measured
    jitter must not pick the flags; ties go to the serial, shallower
    schedule.  A later call with the same key measures nothing.

    Under a process group every rank sweeps the ranked plan together and
    returns the same config; rank 0 alone reads and writes the cache, under
    a key that carries the world size.

    Raises:
        ValueError: ``hosts`` is not a multiple of the group's ranks.
        RuntimeError: no candidate fits, or none of the measured verified.
    """
    _check_hosts(hosts)
    key = _keyed(f"soa-stencil-h{hosts}", L, dtype, accum_dtype, compression, device,
                 world=_ranked_world(None))
    hit = _cache_hit(key, _valid_stencil_hit, cache, refresh, cache_directory)
    if hit is not None:
        return hit
    sweep = stencil_sweep(L=L, dtype=dtype, accum_dtype=accum_dtype, hosts=hosts,
                          compression=compression, prune=prune, tiles=tiles,
                          measure_fn=measure_fn, hw=hw, device=device)

    def pick(rows: list[dict]) -> dict:
        best_tile = max(rows, key=lambda r: r["measured_gflops"])["tile"]
        return max((r for r in rows if r["tile"] == best_tile),
                   key=lambda r: (r["predicted_gflops"], not r["overlap"], -r["depth"]))

    def config(w: dict) -> dict:
        prov = _provenance(sweep, w, hosts, compression)
        prov["halo_bytes_per_exchange"] = w.get("halo_bytes_per_exchange", 0)
        return {"layout": "soa", "variant": "cuda_stencil", "tile": w["tile"],
                "overlap": w["overlap"], "depth": w["depth"], "stencil": prov}

    return _tuned(key, sweep, pick, config, cache, cache_directory)


# ---------------------------------------------------------------------------
# CG iteration tuning: (tile, fused).  The fused pass saves the standalone
# p' round trip but gathers a second field; which side wins is measured.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CGCandidate:
    """One point of the CG grid: the site tile x the fused stencil+axpy
    kernel or the composed (axpy, stencil, shift) path."""

    tile: int
    fused: bool = True


def enumerate_cg_candidates(
    tiles: tuple[int, ...] = DEFAULT_TILES,
    fused: tuple[bool, ...] = (True, False),
    dtype: str = "float32",
    accum_dtype: str = "",
    compression: str = "none",
    device: torch.device | str | None = None,
) -> list[CGCandidate]:
    """The (tile, fused) grid; on the card a form whose kernel (the CG body
    when fused, the stencil when composed) fails its register gate gives
    no candidate."""
    on_card = resolve_device(device).type == "cuda"
    keep = {f: not on_card or _stencil_budget_fits("cg" if f else "stencil", dtype,
                                                   accum_dtype, compression)
            for f in fused}
    return [CGCandidate(tile, f) for tile in tiles for f in fused if keep[f]]


# words per site of the composed iteration's own axpy pass: read r and p,
# write p'
_AXPY_WORDS_PER_SITE = 18


def predict_cg(
    cand: CGCandidate,
    L: int,
    dtype: str = "float32",
    accum_dtype: str = "",
    hosts: int = 1,
    hw: roofline.HardwareSpec | None = None,
    compression: str = "none",
    world: int | None = None,
) -> dict[str, Any]:
    """Roofline prediction of one CG iteration under ``cand`` on a
    ``hosts``-slab plan (where ``cg_solve`` splits the pass by default).

    Bytes: :func:`roofline.cg_iteration_bound` (fused kernel, two gathers,
    the epilogue of ``CG_EPILOGUE_WORDS_PER_SITE``); composed swaps the
    fused kernel and one gather for the axpy pass and the stencil kernel.
    Compute: 648 flops/site at the FP32 rate.  Issue: the kernel's FP32
    operations plus its launches.  On several slabs the exchange copies the
    ghosts of r and p (fused) or of p' (composed) under the interior pass,
    and the boundary recompute adds ``boundary_fraction`` of a kernel pass:
    ``bound = max(core, halo) + boundary_fraction * kernel``.

    On ``world`` ranks (default: the running group's; none without one)
    each rank runs its ``1 / world`` of the sites, the exchange is
    :func:`_ranked_exchange`'s, and the iteration's two reductions add
    :data:`CG_REDUCTION_LATENCY_S`.  Without a group the prediction is the
    one card's above.

    Raises:
        LookupError: when no ``hw`` is given and the card is unknown.
    """
    hw = hw if hw is not None else roofline.current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    n_sites = L**4
    padded = ((n_sites + cand.tile - 1) // cand.tile) * cand.tile
    cfg = EngineConfig(L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
                       tile=cand.tile)
    terms = roofline.cg_iteration_bound(cfg, hw)
    if cand.fused:
        kernel, stream_bytes = terms["kernel"], terms["total"].bytes
        ops = stencil_ops_per_site(dtype, accum_dtype, compression, cg=True)
    else:
        kernel = roofline.stencil_bound(cfg, hw)
        extra = _AXPY_WORDS_PER_SITE * cfg.word_bytes * n_sites
        stream_bytes = terms["total"].bytes - terms["kernel"].bytes + kernel.bytes + extra
        stream_bytes -= terms["gathers"].bytes / 2  # one gathered field, not two
        ops = stencil_ops_per_site(dtype, accum_dtype, compression) + 12  # + the axpy
    flops = float(su3_stencil.CG_ITER_FLOPS_PER_SITE) * n_sites
    world = _ranked_world(world)
    share = 1 if world is None else world  # the ranks splitting the sites
    compute_s = flops / share / hw.peak_flops_fp32
    memory_s = stream_bytes / share / hw.hbm_bw
    split = hosts > 1
    issue_rate = hw.peak_flops_fp32 / 2
    issue_s = float(ops) * padded / share / issue_rate + LAUNCH_OVERHEAD_S * (2 if split else 1)
    core_s = max(compute_s, memory_s, issue_s)
    halo = _stencil_halo_spec(L, hosts, cfg.word_bytes)
    fields = 2 if cand.fused else 1
    exchange_bytes = _exchange_bytes(halo, hosts, fields, 1) if split else 0
    peer_bytes = 0.0
    if not split:
        halo_s = 0.0
    elif world is None:
        halo_s = _exchange_seconds(exchange_bytes, hw)
    else:
        ex = _ranked_exchange(exchange_bytes, 2 * hosts * halo.boundary_sites * fields, 0,
                              hosts, world, hw)
        halo_s, peer_bytes = ex["seconds"], ex["peer_bytes"]
    boundary_frac = halo.boundary_sites / halo.sites_per_shard if split else 0.0
    kernel_s = kernel.bound_s / share
    bound_s = max(core_s, halo_s) + boundary_frac * kernel_s if split else core_s
    reduce_s = 0.0 if world is None else CG_REDUCTION_LATENCY_S
    bound_s += reduce_s
    return {
        "tile": cand.tile,
        "fused": cand.fused,
        "compression": compression,
        "hosts": hosts,
        "world": world,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "issue_s": issue_s,
        "halo_s": halo_s,
        "reduce_s": reduce_s,
        "bound_s": bound_s,
        "exchange_bytes": exchange_bytes,
        "peer_bytes": peer_bytes,
        "bandwidth_bytes": stream_bytes + exchange_bytes,
        "predicted_gflops": round(flops / bound_s / 1e9, 3),
    }


def measure_cg_candidate(
    cand: CGCandidate, L: int = 8, dtype: str = "float32", accum_dtype: str = "",
    compression: str = "none", iters: int = 4, hosts: int = 1,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Measured per-iteration GFLOPS of one CG variant on a ``hosts``-slab
    plan (useful flops ``CG_ITER_FLOPS_PER_SITE``/site/iteration).  A fused
    candidate is verified against the composed path: bitwise at f32
    storage, within ``verify_tolerance`` of the relative residual
    otherwise; the composed candidate by its residual shrinking.  Under a
    process group the seconds and the verdict are agreed over the ranks, as
    in :func:`measure_stencil_candidate`."""
    cfg = EngineConfig(
        L=L, dtype=dtype, variant="cuda", layout=Layout.SOA, tile=cand.tile,
        accum_dtype=accum_dtype, iterations=2, warmups=1, compression=compression,
    )
    plan = build_plan(cfg, MeshSpec(hosts=hosts).resolve(device))
    u, b = _cg_measure_problem(L)
    u_phys, b_p = plan.pack_gauge(u), plan.pack_rhs(b)

    def run(fused: bool) -> dict[str, Any]:
        state = plan.cg_state_init(b_p)
        for _ in range(iters):
            state = plan.cg_iterate(u_phys, state, fused=fused)
        return state

    state = run(cand.fused)
    best = _best_seconds(lambda: run(cand.fused), plan.device)
    b_rs = float(plan.cg_state_init(b_p)["rs"])
    rs = float(state["rs"])
    if cand.fused:
        oracle = run(False)
        if dtype == "float32":
            same_x, same_r = _same_bits(state["x"], oracle["x"]), _same_bits(state["r"],
                                                                             oracle["r"])
            verified = same_x and same_r
        else:
            tol = verify_tolerance(dtype, accum_dtype, compression == "two_row")
            verified = abs((rs / b_rs) ** 0.5 - (float(oracle["rs"]) / b_rs) ** 0.5) <= tol
    else:
        verified = rs < b_rs
    best, verified = _ranks_agree(best, bool(verified), plan.device)
    gf = su3_stencil.CG_ITER_FLOPS_PER_SITE * L**4 * iters / best / 1e9
    return {"tile": cand.tile, "fused": cand.fused, "measured_gflops": round(gf, 3),
            "verified": bool(verified)}


def cg_sweep(
    L: int = 8,
    dtype: str = "float32",
    accum_dtype: str = "",
    *,
    hosts: int = 1,
    compression: str = "none",
    prune: float = DEFAULT_PRUNE,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    fused: tuple[bool, ...] = (True, False),
    measure_fn: Callable[[CGCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Rank the CG (tile, fused) grid with :func:`predict_cg`; measure the
    top ``prune`` fraction.  On several ranks only tiles that pad no site
    are candidates.

    Raises:
        RuntimeError: no candidate passes the kernels' register gates.
    """
    cands = [c for c in enumerate_cg_candidates(tiles, fused, dtype, accum_dtype, compression,
                                                device)
             if _fits_ranks(c.tile, L, hosts)]
    if not cands:
        raise RuntimeError("no CG candidate fits the kernels' register budgets "
                           "(and, on ranks, the slabs)")
    preds = [predict_cg(c, L, dtype, accum_dtype, hosts, hw, compression=compression)
             for c in cands]
    if measure_fn is None:
        measure_fn = lambda c: measure_cg_candidate(  # noqa: E731
            c, L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
            hosts=hosts, device=device,
        )
    return _ranked_sweep(cands, preds, prune, measure_fn)


# CG entries carry (tile, fused, cg provenance) under "soa-cg-h{hosts}"
_REQUIRED_CG_KEYS = frozenset({"layout", "variant", "tile", "fused", "cg"})


def _valid_cg_hit(hit: Any) -> dict[str, Any] | None:
    if not isinstance(hit, dict):
        return None
    config = hit.get("config")
    if not isinstance(config, dict) or not _REQUIRED_CG_KEYS <= config.keys():
        return None
    return config


def best_cg_config(
    L: int = 8,
    dtype: str = "float32",
    *,
    accum_dtype: str = "",
    compression: str = "none",
    hosts: int = 1,
    cache: bool = True,
    cache_directory: str | None = None,
    refresh: bool = False,
    prune: float = DEFAULT_PRUNE,
    tiles: tuple[int, ...] = DEFAULT_TILES,
    measure_fn: Callable[[CGCandidate], dict[str, Any]] | None = None,
    hw: roofline.HardwareSpec | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """The tuned CG iteration for ``hosts`` slabs: the (tile, fused) point
    with the best MEASURED GFLOPS among the verified candidates, persisted
    under the key layout ``soa-cg-h{hosts}``.

    Under a process group every rank sweeps the ranked plan together and
    returns the same config; rank 0 alone reads and writes the cache, under
    a key that carries the world size.

    Raises:
        ValueError: ``hosts`` is not a multiple of the group's ranks.
        RuntimeError: no candidate fits, or none of the measured verified.
    """
    _check_hosts(hosts)
    key = _keyed(f"soa-cg-h{hosts}", L, dtype, accum_dtype, compression, device,
                 world=_ranked_world(None))
    hit = _cache_hit(key, _valid_cg_hit, cache, refresh, cache_directory)
    if hit is not None:
        return hit
    sweep = cg_sweep(L=L, dtype=dtype, accum_dtype=accum_dtype, hosts=hosts,
                     compression=compression, prune=prune, tiles=tiles,
                     measure_fn=measure_fn, hw=hw, device=device)

    def config(w: dict) -> dict:
        return {"layout": "soa", "variant": "cuda_cg", "tile": w["tile"],
                "fused": w["fused"], "cg": _provenance(sweep, w, hosts, compression)}

    return _tuned(key, sweep, lambda rows: max(rows, key=lambda r: r["measured_gflops"]),
                  config, cache, cache_directory)


def main(argv: list[str] | None = None) -> int:
    """Print the tile, k and layout sweeps, the pipeline sweep and the
    tuned config (``best_config``, through the cache) as a
    :class:`TuneResult`, measured on ``--device`` (the card by default).

        PYTHONPATH=src python -m repro_torch.core.autotune [--L 8] [--device cpu]
    """
    import argparse

    ap = argparse.ArgumentParser(description="the SU3 multiply's sweeps and tuned config")
    ap.add_argument("--L", type=int, default=8, help="lattice extent of the measured engines")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the plain versions")
    ap.add_argument("--cache-dir", default=None,
                    help=f"the tuned config's cache (default: ${CACHE_ENV} or {DEFAULT_CACHE_DIR})")
    args = ap.parse_args(argv)
    dev = cli_device(args.device)
    hw = roofline.current_hardware() if dev.type == "cuda" else None
    if dev.type == "cuda" and hw is None:
        raise LookupError(f"no Hopper spec for {torch.cuda.get_device_name(dev)}")
    hw = hw or roofline.H100_SXM  # on the CPU the model ranks for the H100 SXM
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}; model: {hw.name}; L={args.L}")
    print("== tile sweep (site padding; the kernel's register budget) ==")
    for r in tile_sweep(L=args.L, device=dev):
        print("  ", r)
    print("== k sweep (fused chain depth) ==")
    for r in k_sweep(L=args.L, device=dev):
        print("  ", r)
    print("== layout sweep (traffic) ==")
    counted = layout_sweep(hw=hw)
    for r in counted:
        print("  ", r)
    print("== pipeline sweep (roofline-pruned joint (tile, fused_k)) ==")
    for r in pipeline_sweep(L=args.L, hw=hw, device=dev)["rows"]:
        print("  ", r)
    best = best_config(L=args.L, cache_directory=args.cache_dir, hw=hw, device=dev)
    entry = load_cache(args.cache_dir)[_keyed("soa", args.L, "float32", "", "none", dev)]
    soa = next(r for r in counted if (r["variant"], r["dtype"], r["compression"])
               == ("cuda", "float32", "none"))
    print("best:", TuneResult(
        config=best, measured_gflops=entry["measured_gflops"],
        counted_bytes_per_site=soa["counted_bytes_per_site"],
        model_bytes_per_site=soa["model_bytes_per_site"],
        budget=_budget("float32", "", "none") if dev.type == "cuda" else None,
        bound_gf=soa["hbm_bound_gf"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
