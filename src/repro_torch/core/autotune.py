"""SU3 autotune for the port: the multiply's roofline-pruned pipeline sweep,
its cache, and the CG measurement problem.

Port of the multiply half of ``repro.core.autotune``: enumerate the joint
(tile, fused_k) grid, rank it with a three-term model, MEASURE only the top
``prune`` fraction, keep the best measured candidate and persist it, so the
engine and the serving stack start from the tuned tuple for free.

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

The stencil and CG sweeps are not ported yet.

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
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import roofline
from repro_torch.core.su3 import layouts
from repro_torch.core.su3.engine import SU3Engine
from repro_torch.core.su3.layouts import Layout
from repro_torch.core.su3.plan import EngineConfig, resolve_device
from repro_torch.kernels import su3_matmul

CACHE_ENV = "REPRO_TORCH_SU3_CACHE_DIR"
CACHE_FILE = "su3_autotune.json"
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "autotune"
SCHEMA_VERSION = 1  # the port's own schema; reference entries never share a file
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


# ---------------------------------------------------------------------------
# Roofline-pruned pipeline sweep: rank the (tile, fused_k) grid with the
# three-term model, measure only the top fraction.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineCandidate:
    """One point of the joint (tile, fused chain depth) grid."""

    tile: int
    fused_k: int


def _budget_fits(dtype: str, accum_dtype: str, compression: str) -> bool:
    """The register gate: the kernel instantiation spills nothing and fits
    at least one block per SM (on the current CUDA device)."""
    budget = su3_matmul.kernel_budget(
        torch.float32 if dtype == "float32" else torch.bfloat16,
        accum_dtype or None, compression == "two_row",
    )
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
    order = sorted(range(len(cands)), key=lambda i: -preds[i]["predicted_gflops"])
    n_meas = len(cands) if prune >= 1 else max(1, math.ceil(prune * len(cands)))
    if measure_fn is None:
        measure_fn = lambda c: measure_candidate(  # noqa: E731
            c, L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
            device=device,
        )
    rows = []
    for rank, i in enumerate(order[:n_meas]):
        row = dict(preds[i])
        row.update(measure_fn(cands[i]))
        row["predicted_rank"] = rank
        rows.append(row)
    return {
        "rows": rows,
        "candidates_total": len(cands),
        "candidates_measured": n_meas,
        "prune": prune,
    }


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
    schema: int = SCHEMA_VERSION,
) -> str:
    """Versioned cache key: a ``v{schema}`` prefix, so entries of another
    schema never match, and ``compression`` as its own segment, so an
    18-real and a two-row decision for the same (dtype, L) never alias."""
    return (
        f"v{schema}|{backend}|{device_kind}|{layout}|{dtype}"
        f"|{compression}|L{L}|d{n_devices}"
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
    backend, device_kind, n_devices = _device_identity(device)
    dtype_key = f"{dtype}+acc-{accum_dtype}" if accum_dtype else dtype
    key = cache_key(
        backend=backend, device_kind=device_kind, layout="soa",
        dtype=dtype_key, L=L, n_devices=n_devices, compression=compression,
    )
    if cache and not refresh:
        config = _valid_cache_hit(load_cache(cache_directory).get(key))
        if config is not None:
            return dict(config, cached=True)

    sweep = pipeline_sweep(
        L=L, dtype=dtype, accum_dtype=accum_dtype, compression=compression,
        prune=prune, measure_fn=measure_fn, hw=hw, device=device,
    )
    rows = [r for r in sweep["rows"] if r["verified"]]
    if not rows:
        raise RuntimeError("no verified pipeline candidate in the measured set")
    winner = max(rows, key=lambda r: r["measured_gflops"])
    config = {
        "layout": "soa", "variant": "cuda",
        "tile": winner["tile"], "fused_k": winner["fused_k"],
        "compression": compression,
        "pipeline": {
            "schema": SCHEMA_VERSION,
            "prune": sweep["prune"],
            "candidates_total": sweep["candidates_total"],
            "candidates_measured": sweep["candidates_measured"],
            "predicted_gflops": winner.get("predicted_gflops", 0.0),
            "predicted_rank": winner.get("predicted_rank", 0),
        },
    }
    if cache:
        store_cache_entry(
            key,
            {"config": config, "measured_gflops": winner["measured_gflops"], "key": key},
            cache_directory,
        )
    return dict(config, cached=False)


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
