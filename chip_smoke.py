#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SU3_Bench on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA device and nvcc.  It
builds every CUDA source of the port (``build/repro_torch/``), holds the
kernel against its plain PyTorch version on random SU(3) links at L=32,
drives ``SU3Engine.run()`` and ``run_fused(8)`` at the paper's L=32 lattice
with the launch counter reset around them, times the kernel against its
bound, its plain version and one ``torch.matmul`` yardstick, and prints:

  * the card's name and power limit (nvidia-smi) and the tool versions;
  * one JSON line per check, per engine row and per yardstick;
  * a ``{"kernels": [...]}`` line with each ported kernel's numbers;
  * last, ``{"ok": true, "device": {...}}`` — only if every phase passed.

Without CUDA, or without the rest of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/csrc/su3_mult.cu"
REPLACES = "src/repro/kernels/su3_matmul.py:199"  # su3_mult_planar (pallas_call at :229)
FUSED_K = 8
FUSED_REPS = 3  # SU3Engine.run_fused's default


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _tool_line(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def random_su3(rng, shape: tuple[int, ...]):
    """Random SU(3) matrices (*shape, 3, 3) complex64: Gram-Schmidt on two
    random complex rows, row 2 = conj(row0 x row1), so det = 1."""
    import numpy as np

    g = rng.standard_normal(shape + (2, 3, 2))
    g = g[..., 0] + 1j * g[..., 1]
    u0 = g[..., 0, :] / np.linalg.norm(g[..., 0, :], axis=-1, keepdims=True)
    v = g[..., 1, :] - np.sum(u0.conj() * g[..., 1, :], axis=-1, keepdims=True) * u0
    u1 = v / np.linalg.norm(v, axis=-1, keepdims=True)
    u2 = np.conj(np.cross(u0, u1))
    return np.stack([u0, u1, u2], axis=-2).astype(np.complex64)


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random SU(3) data")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.engine import SU3Engine
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import _build, su3_matmul

    failures: list[str] = []
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    hw = roofline.hardware_for_device(name)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick runs in full f32

    # -- 1. the card and the tools ---------------------------------------------
    print(_tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": _tool_line([_build.nvcc_path(), "--version"]),
           "device": name, "count": torch.cuda.device_count(),
           "spec": hw.name if hw else None})

    # -- 2. build (set-up time) ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    _build.load("su3_mult")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(logs)})
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")
    for mode, (dtype, accum) in {"f32": (torch.float32, None),
                                 "bf16": (torch.bfloat16, None),
                                 "bf16+acc-f32": (torch.bfloat16, "float32")}.items():
        for compressed in (False, True):
            for aosoa in (False, True):
                budget = su3_matmul.kernel_budget(dtype, accum, compressed, aosoa)
                _emit({"kernel_budget": "su3_mult_planar", "mode": mode,
                       "two_row": compressed, "aosoa": aosoa, **budget})

    # -- 3. kernel vs plain version on random SU(3) links, L=32 --------------------
    n_sites = PAPER_L32.shape.n_sites
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    u = torch.from_numpy(random_su3(rng, (n_sites, layouts.LINKS))).to(dev)
    b_c = torch.from_numpy(random_su3(rng, (layouts.LINKS,))).to(dev)
    _emit({"phase": "data", "sites": n_sites, "seconds": time.perf_counter() - t0})

    checks = [  # (layout, dtype, accum, compression, k)
        ("soa", "float32", "", "none", 1), ("soa", "float32", "", "none", 8),
        ("soa", "float32", "", "none", 13), ("aosoa", "float32", "", "none", 1),
        ("soa", "bfloat16", "float32", "none", 1), ("soa", "bfloat16", "float32", "none", 8),
        ("soa", "float32", "", "two_row", 1), ("soa", "float32", "", "two_row", 8),
        ("soa", "bfloat16", "", "two_row", 1), ("soa", "bfloat16", "", "none", 8),
        ("aosoa", "bfloat16", "float32", "two_row", 8),
    ]
    max_err = 0.0
    for layout, dtype, accum, comp, k in checks:
        codec = layouts.make_codec(Layout(layout), tile=PAPER_L32.tile, dtype=dtype,
                                   accum_dtype=accum, compression=comp)
        a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
        kw = {"k_iters": k, "accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = su3_matmul.su3_mult_planar(a, b, tile=codec.tile, **kw)
        plain = codec.from_planar_view(
            su3_matmul.su3_mult_planar_plain(codec.planar_view(a), b, **kw), a)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got.float() - plain.float())).item()
        tol = verify_tolerance(dtype, accum, codec.is_compressed)
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        max_err = max(max_err, err)
        _emit({"check": "kernel_vs_plain", "layout": layout, "dtype": dtype,
               "accum": accum or dtype, "compression": comp, "k": k,
               "max_abs_err": err, "tol": tol, "bitwise": err == 0.0, "ok": ok})
        if not ok:
            failures.append(f"kernel vs plain {layout}/{dtype}/{accum}/{comp}/k={k}: {err}")

    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile)
    a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    chained = su3_matmul.su3_mult_planar(a, b, k_iters=13)
    x = a
    for _ in range(13):
        x = su3_matmul.su3_mult_planar(x, b)
    in_place = a.clone()
    aliased = su3_matmul.su3_mult_planar(in_place, b, k_iters=13, alias=True)
    torch.cuda.synchronize()
    chain_ok = torch.equal(chained, x)
    alias_ok = aliased.data_ptr() == in_place.data_ptr() and torch.equal(in_place, chained)
    _emit({"check": "13-chain bitwise equals 13 single launches (f32)", "ok": chain_ok})
    _emit({"check": "in-place 13-chain equals out-of-place", "ok": alias_ok})
    if not (chain_ok and alias_ok):
        failures.append("13-chain bitwise / in-place check")

    # -- 4. the main path: SU3Engine at PAPER_L32 ---------------------------------
    rows = [
        ("soa f32", PAPER_L32),
        ("aosoa f32", dataclasses.replace(PAPER_L32, layout=Layout.AOSOA)),
        ("soa bf16+acc-f32",
         dataclasses.replace(PAPER_L32, dtype="bfloat16", accum_dtype="float32")),
        ("soa f32 two-row", dataclasses.replace(PAPER_L32, compression="two_row")),
        ("soa f32 host_scatter", dataclasses.replace(PAPER_L32, placement="host_scatter")),
    ]
    su3_matmul.LAUNCHES.count = 0
    for label, cfg in rows:
        engine = SU3Engine(cfg)
        modes = [("run", lambda: engine.run(), cfg.warmups + cfg.iterations)]
        if cfg.placement == "sharded":
            modes.append((f"run_fused({FUSED_K})", lambda: engine.run_fused(FUSED_K, reps=FUSED_REPS),
                          max(1, cfg.warmups) + FUSED_REPS))
        for mode, fn, expected in modes:
            before = su3_matmul.LAUNCHES.count
            r = fn()
            launches = su3_matmul.LAUNCHES.count - before
            row = r.row()
            out = {"row": label, "mode": mode, "verified": row["verified"],
                   "best_ms": row["best_s"] * 1e3, "mean_ms": row["mean_s"] * 1e3,
                   "GBYTES": row["GBYTES"], "GFLOPS": row["GFLOPS"],
                   "bound_ms": None if row["bound_s"] is None else row["bound_s"] * 1e3,
                   "bound_share": row["bound_share"], "launches": launches,
                   "expected_launches": expected, "init_s": row["init_s"],
                   "scatter_s": row["scatter_s"], "plan": row["plan"]}
            ok = launches == expected and row["verified"]
            if not row["verified"] and cfg.is_mixed_precision and mode != "run":
                # su3_bench's fixed point is not one for bf16 B under an f32
                # chain (the reference fails it too): hold the output to the
                # drift that B = bf16(1/3) predicts instead.
                out["drift_matches"] = _drift_matches(engine, FUSED_K, 1 + FUSED_REPS)
                out["note"] = ("bf16(1/3) = 0.333984375: an f32 chain drifts by 1.00195x "
                               "per multiply off the (1,0) fixed point; checked against it")
                ok = launches == expected and out["drift_matches"]
            out["ok"] = ok
            _emit(out)
            if not ok:
                failures.append(f"engine {label} {mode}: {out}")
    main_path_launches = su3_matmul.LAUNCHES.count
    if main_path_launches == 0:
        failures.append("the main path never launched su3_mult_planar")

    # -- 5. yardsticks at the main path's shape (SoA f32, k=1, L=32) ----------------
    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile)
    a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    kernel_ms = _time_ms(lambda: su3_matmul.su3_mult_planar(a, b), reps=50)
    plain_ms = _time_ms(lambda: su3_matmul.su3_mult_planar_plain(a, b), reps=5, warmup=1)
    b_mat = b_c.contiguous()
    library_ms = _time_ms(lambda: torch.matmul(u, b_mat), reps=20)
    bytes_moved = 2 * a.numel() * a.element_size() + b.numel() * b.element_size()
    ops_done = layouts.TrafficModel(Layout.SOA, n_sites, 4).flops_per_site * n_sites
    bound_ms = bound_by = None
    if hw is not None:  # A read + C written + B read, once each
        bound = roofline.SU3Roofline("su3_mult_planar", hw, flops=ops_done, bytes=bytes_moved)
        bound_ms, bound_by = bound.bound_s * 1e3, bound.bound_by
    _emit({"yardstick": "su3_mult_planar soa f32 k=1 L=32", "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "torch.matmul((S,4,3,3) complex64, (4,3,3) complex64)",
           "bytes": bytes_moved, "flops": ops_done, "bound_ms": bound_ms,
           "kernel_GBps": bytes_moved / kernel_ms / 1e6,
           "bound_share": None if bound_ms is None else bound_ms / kernel_ms})

    # -- 6. the kernels line -----------------------------------------------------------
    _emit({"kernels": [{
        "name": "su3_mult_planar", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]})

    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _drift_matches(engine, k: int, launches: int) -> bool:
    """Run ``launches`` fused k-chains from the uniform lattice and compare
    every stored word with the host's prediction: per launch an f32 chain of
    ``y = ((x*b + x*b) + x*b)`` with b = bf16(1/3), rounded to bf16 once."""
    import numpy as np
    import torch

    plan = engine.plan
    a, b, _, _ = plan.init_data()
    step = plan.fused_step(k)
    x = a
    for _ in range(launches):
        x = step(x, b)
    bw = np.float32(torch.tensor(1.0 / 3.0).to(torch.bfloat16).float().item())
    v = np.float32(1.0)
    for _ in range(launches):
        for _ in range(k):
            p = np.float32(v * bw)
            v = np.float32(np.float32(p + p) + p)
        v = np.float32(torch.tensor(float(v)).to(torch.bfloat16).float().item())
    c = plan.unpack(x)[:, :, : plan.codec.stored_rows, :]
    return bool(torch.all(c.real == float(v)).item() and torch.all(c.imag == 0).item())


if __name__ == "__main__":
    sys.exit(main())
