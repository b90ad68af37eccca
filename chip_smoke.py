#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SU3_Bench on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA device and nvcc.  It
builds every CUDA source of the port (``build/repro_torch/``, one nvcc per
source, started together) and, at the paper's L=32 lattice:

  * holds each kernel (the multiply, the slot-batched serving megakernel,
    the stencil, the fused CG body) against its plain PyTorch version on
    random SU(3) links and random vectors, in every storage form;
  * drives the main paths with the launch counters set to 0 just before
    each and read just after: ``SU3Engine.run()`` / ``run_fused(8)``,
    ``ExecutionPlan.stencil_step()`` (and ``depth=2``) on the stencil's
    fixed point, ``ExecutionPlan.cg_solve`` fused and composed on the CG
    measurement problem, held against the plain ``cg_reference_solve``,
    and ``SU3Service`` in its batch, continuous and megakernel modes on one
    seeded request stream (multiplies at L=16 and L=32, then a stencil
    batch and a solve), autotuned against a fresh cache under ``build/``;
  * times each kernel against its bound, its plain version and, where one
    PyTorch call computes the same function, that call.

It prints:

  * the card's name and power limit (nvidia-smi) and the tool versions;
  * one JSON line per check, per main-path row and per yardstick;
  * a ``{"kernels": [...]}`` line with each ported kernel's numbers;
  * last, ``{"ok": true, "device": {...}}`` — only if every phase passed.

The whole output is over 20 KB; where only the end of a log is kept, run
``mkdir -p build && python3 chip_smoke.py | tee build/chip_smoke.log`` to
keep all of it.  Without CUDA, or without the rest of the repository, it
exits non-zero and prints no result.
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
STENCIL_SOURCE = "src/repro_torch/csrc/su3_stencil.cu"
STENCIL_REPLACES = "src/repro/kernels/su3_stencil.py:136"  # su3_stencil_planar (pallas_call :159)
CG_REPLACES = "src/repro/kernels/su3_stencil.py:240"  # su3_cg_fused_planar (pallas_call :276)
MEGA_REPLACES = "src/repro/kernels/su3_matmul.py:292"  # su3_mult_planar_batched (pallas_call :340)
SLOT_K = [0, 1, 3, 8, 13]  # dead, single, deep, max_k, above max_k (clamped to max_k)
MAX_K = 8
SERVICE_LS = (16, 32)  # the stream's lattice sizes: the small one arrives first
SERVICE_STREAM = [(0, 3), (0, 8), (0, 1), (0, 5), (1, 2), (1, 7), (1, 4), (1, 6)]  # (L index, k)
TABLE_SLOTS = 8
FUSED_K = 8
FUSED_REPS = 3  # SU3Engine.run_fused's default
STENCIL_REPS = 20  # timed stencil steps per main-path row
CG_TIMED_ITERS = 20
BETA = 0.3718  # the CG body's beta in the kernel checks (nonzero)


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


def _best_ms(fn, reps: int, warmup: int = 2) -> float:
    """Best ms of one call over ``reps`` calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return min(a.elapsed_time(b) for a, b in pairs)


def _bits(x):
    import torch

    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _counters() -> tuple:
    from repro_torch.kernels import su3_matmul, su3_stencil

    return (su3_matmul.LAUNCHES, su3_matmul.MEGA_LAUNCHES, su3_stencil.STENCIL_LAUNCHES,
            su3_stencil.CG_LAUNCHES)


def _reset_counts() -> None:
    for counter in _counters():
        counter.count = 0


def _counts() -> dict[str, int]:
    return {c.name: c.count for c in _counters()}


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
    from repro_torch.kernels import _build, su3_matmul, su3_stencil

    failures: list[str] = []
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    hw = roofline.hardware_for_device(name)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick runs in full f32

    # -- 1. the card and the tools ---------------------------------------------
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card)
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": _tool_line([_build.nvcc_path(), "--version"]),
           "device": name, "count": torch.cuda.device_count(),
           "spec": hw.name if hw else None})

    # -- 2. build (set-up time) ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    _build.load("su3_mult")
    _build.load("su3_stencil")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(logs)})
    for src, log in logs.items():  # one line per source: registers and spills per kernel
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"ptxas[{src}]: registers per kernel {regs}; {' | '.join(spills)}")
    budgets: dict[str, list] = {}
    for mode, (dtype, accum) in {"f32": (torch.float32, None),
                                 "bf16": (torch.bfloat16, None),
                                 "bf16+acc-f32": (torch.bfloat16, "float32")}.items():
        for compressed in (False, True):
            for aosoa in (False, True):
                found = {
                    "su3_mult_planar": su3_matmul.kernel_budget(dtype, accum, compressed, aosoa),
                    "su3_mult_planar_batched": su3_matmul.kernel_budget(
                        dtype, accum, compressed, aosoa, megakernel=True),
                    "su3_stencil_planar": su3_stencil.kernel_budget(
                        "stencil", dtype, accum, compressed, aosoa),
                    "su3_cg_fused_planar": su3_stencil.kernel_budget(
                        "cg", dtype, accum, compressed, aosoa),
                }
                for kname, b in found.items():
                    budgets.setdefault(kname, []).append(
                        [mode, compressed, aosoa, b["num_regs"], b["local_bytes"],
                         b["threads_per_block"], b["blocks_per_sm"], b["occupancy"]])
    for kname, forms in budgets.items():
        _emit({"kernel_budget": kname,
               "columns": ["mode", "two_row", "aosoa", "num_regs", "local_bytes",
                           "threads_per_block", "blocks_per_sm", "occupancy"], "forms": forms})

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
    _reset_counts()
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

    # -- 4b. stencil and CG kernels vs their plain versions, L=32 ------------------
    vecs = _stencil_data(rng, n_sites, dev)
    _emit({"phase": "stencil data", "sites": n_sites})
    stencil_err, cg_err = _stencil_kernel_checks(u, vecs, failures)

    # -- 4c. the main path: stencil_step at PAPER_L32 ---------------------------------
    stencil_rows = _stencil_main_path(hw, failures)
    # -- 4d. the main path: cg_solve at PAPER_L32 -------------------------------------
    cg_launches, stencil_cg_launches = _cg_main_path(hw, failures)
    stencil_launches = sum(r["launches"] for r in stencil_rows) + stencil_cg_launches
    if stencil_launches == 0:
        failures.append("the main path never launched su3_stencil_planar")
    if cg_launches == 0:
        failures.append("the main path never launched su3_cg_fused_planar")

    # -- 4e. the serving megakernel vs its plain version, L=32 slot tables ----------
    mega_err = _megakernel_checks(u, rng, failures)
    # -- 4f. the main path: SU3Service in its three dispatch modes --------------------
    mega_launches, svc_counts = _service_main_path(u, rng, failures)
    if mega_launches == 0:
        failures.append("the main path never launched su3_mult_planar_batched")
    stencil_launches += svc_counts["su3_stencil_planar"]
    cg_launches += svc_counts["su3_cg_fused_planar"]

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

    # pure bf16 rounds after every operation (as the reference does): time
    # what that costs the multiply, at k=1 and in an 8-chain
    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile, dtype="bfloat16")
    a16, b16 = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    bf16_ms = {k: _time_ms(lambda: su3_matmul.su3_mult_planar(a16, b16, k_iters=k), reps=20)
               for k in (1, FUSED_K)}
    bf16_bytes = 2 * a16.numel() * a16.element_size()
    _emit({"yardstick": "su3_mult_planar soa pure bf16 L=32", "k1_ms": bf16_ms[1],
           f"k{FUSED_K}_ms": bf16_ms[FUSED_K],
           "k1_bound_ms": None if hw is None else bf16_bytes / hw.hbm_bw * 1e3,
           "note": "every product, sum and difference rounds to bf16"})
    del a16

    st, cg = _stencil_yardsticks(u, vecs, hw, failures)
    mega = _megakernel_yardsticks(u, rng, hw)

    # -- 6. the kernels line -----------------------------------------------------------
    _emit({"kernels": [{
        "name": "su3_mult_planar", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "su3_mult_planar_batched", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": MEGA_REPLACES, "launches": mega_launches, "max_abs_err": mega_err, **mega,
    }, {
        "name": "su3_stencil_planar", "route": "cuda", "source": STENCIL_SOURCE,
        "replaces": STENCIL_REPLACES, "launches": stencil_launches, "max_abs_err": stencil_err,
        **st,
    }, {
        "name": "su3_cg_fused_planar", "route": "cuda", "source": STENCIL_SOURCE,
        "replaces": CG_REPLACES, "launches": cg_launches, "max_abs_err": cg_err, **cg,
    }]})

    print(card)  # again, next to the results (the first lines may scroll away)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


STENCIL_FORMS = [  # (label, layout, dtype, accum, compression)
    ("soa f32", "soa", "float32", "", "none"),
    ("aosoa f32", "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", "soa", "bfloat16", "float32", "none"),
    ("soa bf16", "soa", "bfloat16", "", "none"),
    ("soa f32 two-row", "soa", "float32", "", "two_row"),
    ("soa bf16 two-row", "soa", "bfloat16", "", "two_row"),
]


def _stencil_data(rng, n_sites: int, dev) -> dict:
    """Random f32 neighbour blocks and vectors on the card, from the seed."""
    import numpy as np
    import torch

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    return {"v_nbr": normal(8, 2, 3, n_sites), "r_nbr": normal(8, 2, 3, n_sites),
            "p_nbr": normal(8, 2, 3, n_sites), "r": normal(2, 3, n_sites),
            "p": normal(2, 3, n_sites),
            "coefs": torch.tensor([[BETA, 16.0]], dtype=torch.float32, device=dev)}


def _stencil_kernel_checks(u, vecs: dict, failures: list[str]) -> tuple[float, float]:
    """Both kernels against their plain versions in every form: bitwise at
    f32 storage, within ``verify_tolerance`` otherwise.  Returns the largest
    error of each kernel."""
    import numpy as np
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import su3_stencil

    worst = {"su3_stencil_planar": 0.0, "su3_cg_fused_planar": 0.0}
    for label, layout, dtype, accum, comp in STENCIL_FORMS:
        codec = layouts.make_codec(layout, tile=PAPER_L32.tile, dtype=dtype, accum_dtype=accum,
                                   compression=comp)
        u_phys = codec.pack(u).contiguous()
        u_plain = codec.planar_view(u_phys)
        w = {k: (t if k == "coefs" else t.to(codec.word_dtype)) for k, t in vecs.items()}
        kw = {"accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = {"su3_stencil_planar": [su3_stencil.su3_stencil_planar(u_phys, w["v_nbr"], **kw)],
               "su3_cg_fused_planar": list(su3_stencil.su3_cg_fused_planar(
                   u_phys, w["r_nbr"], w["p_nbr"], w["r"], w["p"], w["coefs"], **kw))}
        want = {"su3_stencil_planar": [su3_stencil.su3_stencil_planar_plain(
                    u_plain, w["v_nbr"], **kw)],
                "su3_cg_fused_planar": list(su3_stencil.su3_cg_fused_planar_plain(
                    u_plain, w["r_nbr"], w["p_nbr"], w["r"], w["p"], w["coefs"], **kw))}
        torch.cuda.synchronize()
        tol = verify_tolerance(dtype, accum, codec.is_compressed)
        for name in got:
            err = max(torch.max(torch.abs(g.float() - x.float())).item()
                      for g, x in zip(got[name], want[name]))
            bitwise = all(torch.equal(_bits(g), _bits(x)) for g, x in zip(got[name], want[name]))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got[name])
            ok = finite and (bitwise if dtype == "float32" else err <= tol)
            worst[name] = max(worst[name], err)
            _emit({"check": "kernel_vs_plain", "kernel": name, "form": label,
                   "max_abs_err": err, "tol": 0.0 if dtype == "float32" else tol,
                   "bitwise": bitwise, "ok": ok})
            if not ok:
                failures.append(f"{name} vs plain {label}: err {err}, bitwise {bitwise}")

    # a random site subset (links and neighbours gathered there) gives the
    # full pass's bits at those sites
    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    u_soa = codec.pack(u).contiguous()
    full = su3_stencil.su3_stencil_planar(u_soa, vecs["v_nbr"])
    gen = np.random.default_rng(1)
    idx = torch.from_numpy(gen.permutation(u.shape[0])[: 1 << 18]).to(u.device)
    sub = su3_stencil.su3_stencil_planar(u_soa[:, :, idx].contiguous(),
                                         vecs["v_nbr"][..., idx].contiguous())
    torch.cuda.synchronize()
    subset_ok = torch.equal(_bits(sub), _bits(full[:, :, idx]))
    _emit({"check": "stencil on a random 2^18-site subset equals the full pass (f32)",
           "bitwise": subset_ok, "ok": subset_ok})
    if not subset_ok:
        failures.append("stencil site-subset check")
    return worst["su3_stencil_planar"], worst["su3_cg_fused_planar"]


def _stencil_main_path(hw, failures: list[str]) -> list[dict]:
    """``build_plan`` -> ``init_stencil_data`` -> ``stencil_step`` at
    PAPER_L32 in four forms: counted launches, the fixed point, depth 2
    against two single steps, and the step / gather / kernel times."""
    import dataclasses

    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import build_plan
    from repro_torch.kernels import su3_stencil

    rows = [
        ("soa f32", PAPER_L32),
        ("aosoa f32", dataclasses.replace(PAPER_L32, layout=Layout.AOSOA)),
        ("soa bf16+acc-f32", dataclasses.replace(PAPER_L32, dtype="bfloat16",
                                                 accum_dtype="float32")),
        ("soa f32 two-row", dataclasses.replace(PAPER_L32, compression="two_row")),
    ]
    out_rows = []
    for label, cfg in rows:
        plan = build_plan(cfg)
        u_phys, v_p = plan.init_stencil_data()
        step, step2 = plan.stencil_step(), plan.stencil_step(depth=2)
        torch.cuda.synchronize()
        _reset_counts()
        out = step(u_phys, v_p)
        twice = step(u_phys, step(u_phys, v_p))
        depth2 = step2(u_phys, v_p)
        step_ms = _best_ms(lambda: step(u_phys, v_p), STENCIL_REPS)
        calls = 1 + 2 + 2 + 2 + STENCIL_REPS  # single, two singles, depth 2, warmup, timed
        counts = _counts()
        verified = plan.verify_stencil(out)
        depth2_ok = torch.equal(_bits(depth2), _bits(twice))
        # the split, outside the counted window: the gather alone, the kernel alone
        gather_ms = _best_ms(lambda: plan.gather_neighbors(v_p), STENCIL_REPS)
        kernel, kw = plan._stencil_kernel_kwargs()
        v_nbr = plan.gather_neighbors(v_p)
        kernel_ms = _best_ms(lambda: kernel.fn(u_phys, v_nbr, **kw), STENCIL_REPS)
        bound = roofline.stencil_bound(cfg, hw) if hw is not None else None
        gather_bytes = roofline.GATHER_WORDS_PER_SITE * cfg.word_bytes * cfg.shape.n_sites
        row = {"row": label, "mode": "stencil_step", "verified": verified,
               "depth2_equals_two_steps": depth2_ok, "step_ms": step_ms,
               "gather_ms": gather_ms, "kernel_ms": kernel_ms,
               "kernel_GBps": None if bound is None else bound.bytes / kernel_ms / 1e6,
               "bound_ms": None if bound is None else bound.bound_s * 1e3,
               "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
               "step_bound_ms": None if bound is None else
               (bound.bytes + gather_bytes) / hw.hbm_bw * 1e3,
               "launches": counts[su3_stencil.STENCIL_LAUNCHES.name],
               "expected_launches": calls, "plan": plan.describe()}
        row["step_bound_share"] = (None if bound is None else row["step_bound_ms"] / step_ms)
        row["ok"] = verified and depth2_ok and row["launches"] == calls and \
            counts[su3_stencil.CG_LAUNCHES.name] == 0
        _emit(row)
        if not row["ok"]:
            failures.append(f"stencil main path {label}: {row}")
        out_rows.append(row)
        del plan, u_phys, v_p, out, twice, depth2, v_nbr
    return out_rows


def _cg_main_path(hw, failures: list[str]) -> tuple[int, int]:
    """``cg_solve`` at PAPER_L32 on the CG measurement problem, fused and
    composed; the oracle on the card; the per-iteration split; one bf16 +
    f32-accumulation row.  Returns the counted fused-kernel launches and the
    stencil launches of the composed solve."""
    import dataclasses

    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.plan import build_plan, cg_reference_solve
    from repro_torch.kernels import su3_stencil

    L, max_iters = PAPER_L32.L, 200
    t0 = time.perf_counter()
    u_np, b_np = _cg_measure_problem(L)
    _emit({"phase": "cg data", "L": L, "seconds": time.perf_counter() - t0})
    plan = build_plan(PAPER_L32)
    u_phys, b_p = plan.pack_gauge(u_np), plan.pack_rhs(b_np)

    solves, counts = {}, {}
    for fused in (True, False):
        torch.cuda.synchronize()
        _reset_counts()
        solves[fused] = plan.cg_solve(u_phys, b_p, fused=fused, max_iters=max_iters)
        torch.cuda.synchronize()
        counts[fused] = _counts()
    res, comp = solves[True], solves[False]
    dispatched = res.iterations + (1 if res.iterations < max_iters else 0)
    fused_launches = counts[True][su3_stencil.CG_LAUNCHES.name]
    composed_launches = counts[False][su3_stencil.STENCIL_LAUNCHES.name]
    bitwise = (res.residuals == comp.residuals and res.iterations == comp.iterations
               and torch.equal(_bits(res.x_p), _bits(comp.x_p)))

    u_c = torch.from_numpy(u_np).to(plan.device)
    b_c = torch.from_numpy(b_np).to(plan.device)
    _x, oracle, oracle_conv = cg_reference_solve(u_c, b_c, L, max_iters=max_iters)
    close = abs(len(oracle) - res.iterations) <= 1 and all(
        abs(g - w) <= 1e-2 * w for g, w in zip(res.residuals, oracle) if w > 1e-5)
    del u_c, b_c, _x
    row = {"row": "cg soa f32", "mode": "cg_solve", "converged": res.converged,
           "iterations": res.iterations, "residuals": res.residuals,
           "fused_equals_composed_bitwise": bitwise,
           "oracle_iterations": len(oracle), "oracle_residuals": oracle,
           "oracle_converged": oracle_conv, "matches_oracle": close,
           "launches": fused_launches, "expected_launches": dispatched,
           "composed_stencil_launches": composed_launches, "wall_s": res.wall_s}
    row["ok"] = (res.converged and bitwise and close and fused_launches == dispatched
                 and composed_launches == dispatched
                 and counts[True][su3_stencil.STENCIL_LAUNCHES.name] == 0
                 and counts[False][su3_stencil.CG_LAUNCHES.name] == 0)
    _emit(row)
    if not row["ok"]:
        failures.append(f"cg main path: {row}")

    # per-iteration split, outside the counted windows
    state = plan.cg_state_init(b_p)
    for _ in range(2):
        state = plan.cg_iterate(u_phys, state)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CG_TIMED_ITERS):
        state = plan.cg_iterate(u_phys, state)
    end.record()
    torch.cuda.synchronize()
    iter_ms = start.elapsed_time(end) / CG_TIMED_ITERS
    r, p = state["r"], state["p"]
    coefs = plan._cg_helpers()["coef"](state["beta"], 16.0)
    gathers_ms = _best_ms(lambda: (plan.gather_neighbors(r, "r"), plan.gather_neighbors(p, "p")),
                          STENCIL_REPS)
    kernel, kw = plan._stencil_kernel_kwargs("cuda_cg")
    r_nbr, p_nbr = plan.gather_neighbors(r, "r"), plan.gather_neighbors(p, "p")
    kernel_ms = _best_ms(lambda: kernel.fn(u_phys, r_nbr, p_nbr, r, p, coefs, **kw),
                         STENCIL_REPS)
    split = {"row": "cg soa f32", "mode": "cg_iterate split", "iteration_ms": iter_ms,
             "kernel_ms": kernel_ms, "gathers_ms": gathers_ms,
             "rest_ms": iter_ms - kernel_ms - gathers_ms}
    if hw is not None:
        terms = roofline.cg_iteration_bound(PAPER_L32, hw)
        split.update({f"bound_{k}_ms": t.bound_s * 1e3 for k, t in terms.items()})
        split["bound_share"] = terms["total"].bound_s * 1e3 / iter_ms
        split["kernel_bound_share"] = terms["kernel"].bound_s * 1e3 / kernel_ms
    _emit(split)
    del plan, u_phys, b_p, state, r_nbr, p_nbr

    # bf16 storage with f32 accumulation, held to benchmarks/cg_solve.py's TOL_BF16
    cfg = dataclasses.replace(PAPER_L32, dtype="bfloat16", accum_dtype="float32")
    plan = build_plan(cfg)
    torch.cuda.synchronize()
    _reset_counts()
    bf = plan.cg_solve(plan.pack_gauge(u_np), plan.pack_rhs(b_np), tol=2e-2, max_iters=max_iters)
    torch.cuda.synchronize()
    bf_launches = _counts()[su3_stencil.CG_LAUNCHES.name]
    bf_dispatched = bf.iterations + (1 if bf.iterations < max_iters else 0)
    bf_row = {"row": "cg soa bf16+acc-f32", "mode": "cg_solve", "tol": 2e-2,
              "converged": bf.converged, "iterations": bf.iterations,
              "residuals": bf.residuals, "launches": bf_launches,
              "expected_launches": bf_dispatched,
              "ok": bf.converged and bf_launches == bf_dispatched}
    _emit(bf_row)
    if not bf_row["ok"]:
        failures.append(f"cg bf16 row: {bf_row}")
    return fused_launches + bf_launches, composed_launches


def _stencil_yardsticks(u, vecs: dict, hw, failures: list[str]) -> tuple[dict, dict]:
    """Kernel, plain-version and library times of both kernels at SoA f32,
    L=32, on the random data; the entries of the kernels line."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.kernels import su3_stencil

    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    u_soa = codec.pack(u).contiguous()
    v_nbr, r_nbr, p_nbr = vecs["v_nbr"], vecs["r_nbr"], vecs["p_nbr"]
    r, p, coefs = vecs["r"], vecs["p"], vecs["coefs"]
    st_ms = _time_ms(lambda: su3_stencil.su3_stencil_planar(u_soa, v_nbr), reps=50)
    st_plain = _time_ms(lambda: su3_stencil.su3_stencil_planar_plain(u_soa, v_nbr), reps=3,
                        warmup=1)
    # the library yardstick: [U_mu ; U_mu^dagger] and the 8 neighbour vectors
    # as complex64, contracted by one einsum (the same function of the
    # gathered inputs; the port never calls it)
    ut = u.transpose(0, 1)  # (4, S, 3, 3)
    w = torch.cat([ut, ut.conj_physical().transpose(-1, -2)]).contiguous()
    vc = torch.complex(v_nbr[:, 0], v_nbr[:, 1]).transpose(1, 2).contiguous()  # (8, S, 3)
    lib = torch.einsum("dskl,dsl->sk", w, vc)
    st_lib = _time_ms(lambda: torch.einsum("dskl,dsl->sk", w, vc), reps=10)
    kern = su3_stencil.su3_stencil_planar(u_soa, v_nbr)
    lib_err = torch.max(torch.abs(torch.complex(kern[0], kern[1]).T - lib)).item()
    del w, vc, lib
    cg_ms = _time_ms(lambda: su3_stencil.su3_cg_fused_planar(u_soa, r_nbr, p_nbr, r, p, coefs),
                     reps=50)
    cg_plain = _time_ms(lambda: su3_stencil.su3_cg_fused_planar_plain(
        u_soa, r_nbr, p_nbr, r, p, coefs), reps=3, warmup=1)
    st_bound = cg_bound = None
    if hw is not None:
        st_bound = roofline.stencil_bound(PAPER_L32, hw)
        cg_bound = roofline.cg_iteration_bound(PAPER_L32, hw)["kernel"]
    out = {"yardstick": "su3_stencil_planar / su3_cg_fused_planar soa f32 L=32",
           "stencil_ms": st_ms, "stencil_plain_ms": st_plain, "stencil_library_ms": st_lib,
           "library_call": 'torch.einsum("dskl,dsl->sk", W (8,S,3,3) c64, V (8,S,3) c64)',
           "library_max_abs_diff": lib_err, "cg_ms": cg_ms, "cg_plain_ms": cg_plain,
           "cg_library_ms": None}
    if hw is not None:
        out.update(stencil_bound_ms=st_bound.bound_s * 1e3,
                   stencil_bound_share=st_bound.bound_s * 1e3 / st_ms,
                   stencil_GBps=st_bound.bytes / st_ms / 1e6,
                   cg_bound_ms=cg_bound.bound_s * 1e3,
                   cg_bound_share=cg_bound.bound_s * 1e3 / cg_ms,
                   cg_GBps=cg_bound.bytes / cg_ms / 1e6)
    _emit(out)
    if not lib_err <= 1e-4:
        failures.append(f"library yardstick disagrees with the stencil kernel: {lib_err}")

    def entry(ms, plain_ms, bound, library_ms):
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": None if bound is None else bound.bound_s * 1e3,
                "bound_by": None if bound is None else bound.bound_by}

    return entry(st_ms, st_plain, st_bound, st_lib), entry(cg_ms, cg_plain, cg_bound, None)


MEGA_FORMS = [  # (label, layout, dtype, accum, compression)
    ("soa f32", "soa", "float32", "", "none"),
    ("aosoa f32", "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", "soa", "bfloat16", "float32", "none"),
    ("soa bf16", "soa", "bfloat16", "", "none"),
    ("soa f32 two-row", "soa", "float32", "", "two_row"),
    ("soa bf16 two-row", "soa", "bfloat16", "", "two_row"),
]


def _slot_lattices(u, n: int):
    """``n`` distinct random SU(3) lattices from ``u`` (S, 4, 3, 3): slot s
    holds ``u`` rolled by s * 997 sites, made on the card."""
    import torch

    return [torch.roll(u, s * 997, 0) for s in range(n)]


def _megakernel_checks(u, rng, failures: list[str]) -> float:
    """The megakernel against its plain version in every form at L=32 on a
    slot table with mixed depths ``SLOT_K`` (bitwise), a slot's chain
    against single launches, in place against out of place, and the
    multiply's batch axis (``BatchedLatticeRunner.run``) against per-lattice
    launches.  Returns the largest error."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.plan import BatchedLatticeRunner
    from repro_torch.kernels import su3_matmul

    slots = len(SLOT_K)
    lattices = _slot_lattices(u, slots)
    b_c = torch.from_numpy(random_su3(rng, (slots, layouts.LINKS))).to(u.device)
    ks = torch.tensor(SLOT_K, dtype=torch.int32, device=u.device)
    worst = 0.0
    for label, layout, dtype, accum, comp in MEGA_FORMS:
        codec = layouts.make_codec(layout, tile=PAPER_L32.tile, dtype=dtype, accum_dtype=accum,
                                   compression=comp)
        a = torch.stack([codec.pack(x) for x in lattices]).contiguous()
        b = torch.stack([codec.pack_b(x) for x in b_c]).contiguous()
        kw = {"max_k": MAX_K, "accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = su3_matmul.su3_mult_planar_batched(a, b, ks, tile=codec.tile, **kw)
        want = su3_matmul.su3_mult_planar_batched_plain(a, b, ks, **kw)
        in_place = a.clone()
        su3_matmul.su3_mult_planar_batched(in_place, b, ks, tile=codec.tile, alias=True, **kw)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got.float() - want.float())).item()
        bitwise = torch.equal(_bits(got), _bits(want))
        alias_ok = torch.equal(_bits(in_place), _bits(got))
        row = {"check": "megakernel_vs_plain", "form": label, "slot_k": SLOT_K,
               "max_abs_err": err, "bitwise": bitwise, "in_place_equals": alias_ok}
        if label == "soa f32":  # slot chains against single launches
            chains_ok = True
            for s, k in enumerate(SLOT_K):
                x = a[s]
                for _ in range(min(k, MAX_K)):
                    x = su3_matmul.su3_mult_planar(x, b[s], tile=codec.tile)
                chains_ok = chains_ok and torch.equal(_bits(x), _bits(got[s]))
            row["chains_equal_single_launches"] = chains_ok
            bitwise = bitwise and chains_ok
        row["ok"] = bitwise and alias_ok
        worst = max(worst, err)
        _emit(row)
        if not row["ok"]:
            failures.append(f"megakernel vs plain {label}: {row}")
        del a, b, got, want, in_place

    runner = BatchedLatticeRunner(PAPER_L32, u.device)
    a = runner.pack_batch(torch.stack(lattices[:4]))
    b = runner.pack_b_batch(b_c[:4])
    before = su3_matmul.LAUNCHES.count
    batch = runner.run(a, b, k=3)
    one_launch = su3_matmul.LAUNCHES.count - before == 1
    singles = [runner.plan.fused_step(3)(a[s].clone(), b[s]) for s in range(4)]
    torch.cuda.synchronize()
    ok = one_launch and all(torch.equal(_bits(batch[s]), _bits(x)) for s, x in enumerate(singles))
    _emit({"check": "BatchedLatticeRunner.run (one launch, k=3) equals per-lattice launches",
           "one_launch": one_launch, "ok": ok})
    if not ok:
        failures.append("batch-axis run vs per-lattice launches")
    return worst


def _service_main_path(u, rng, failures: list[str]) -> tuple[int, dict[str, int]]:
    """``SU3Service`` on one seeded stream in each dispatch mode: 8
    multiplies (L=16 first, then L=32 while those are in flight), then a
    stencil batch and a CG solve at L=32.  Autotuned against a fresh cache
    under ``build/`` (the first mode sweeps, the others read the cache).
    Returns the megakernel's launches in the megakernel mode's multiply
    window, and the stencil and CG launches of the three stencil+solve
    windows."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import autotune
    from repro_torch.core.su3 import layouts
    from repro_torch.serve.su3 import BatcherConfig, ServiceConfig, SU3Service

    small_L, big_L = SERVICE_LS  # u holds big_L**4 sites
    cache = ROOT / "build" / "chip_smoke_autotune"
    shutil.rmtree(cache, ignore_errors=True)
    big = _slot_lattices(u, 4)
    small = [x[: small_L**4].contiguous() for x in _slot_lattices(u, 4)]
    lattices = [iter(small), iter(big)]
    requests = [(next(lattices[i]), SERVICE_LS[i], k) for i, k in SERVICE_STREAM]
    b_c = torch.from_numpy(random_su3(rng, (len(requests), layouts.LINKS))).to(u.device)
    u_cg, rhs_cg = (torch.from_numpy(x).to(u.device)
                    for x in autotune._cg_measure_problem(big_L))
    v_st = [torch.from_numpy((rng.standard_normal((big_L**4, 3))
                              + 1j * rng.standard_normal((big_L**4, 3))).astype(np.complex64)
                             ).to(u.device) for _ in range(2)]
    modes = {"batch": {}, "continuous": {"continuous": True},
             "megakernel": {"continuous": True, "megakernel": True}}
    mega_launches = 0
    side = {"su3_stencil_planar": 0, "su3_cg_fused_planar": 0}
    tuned = {}
    for mode, flags in modes.items():
        svc = SU3Service(ServiceConfig(
            autotune=True, cache_directory=str(cache), chain_slots=TABLE_SLOTS,
            batcher=BatcherConfig(max_batch=TABLE_SLOTS, warm_batch_sizes=(1, 2, 4, 8)),
            **flags), device=u.device)
        swept = not autotune.load_cache(str(cache))
        t0 = time.perf_counter()
        svc.warm(SERVICE_LS)  # set-up: the autotune sweep (first mode) and first touch
        tuned[mode] = {"warm_s": time.perf_counter() - t0, "swept": swept, **{
            f"L{L}": {k: autotune.best_config(L=L, cache_directory=str(cache), device=u.device)[k]
                      for k in ("tile", "fused_k")} for L in SERVICE_LS}}
        torch.cuda.synchronize()
        # -- the multiply stream: counts from 0 --------------------------------
        _reset_counts()
        t0 = time.perf_counter()
        ids = [svc.submit(a, b_c[i], k=k) for i, (a, L, k) in enumerate(requests)
               if L == small_L]
        svc.step()
        ids += [svc.submit(a, b_c[i], k=k) for i, (a, L, k) in enumerate(requests)
                if L == big_L]
        grew = None
        if mode == "megakernel":
            svc.step()
            table, arrays = svc._tables[0]
            grew = arrays.cap_L == big_L and any(
                r.L == small_L for _s, r, _k in table.occupants())
        svc.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _counts()
        snap = svc.metrics.snapshot()
        results = [svc.pop_result(i) for i in ids]
        # -- held against the chained single-step path (outside the window) ----
        bitwise = True
        for i, ((a, L, k), got) in enumerate(zip(requests, results)):
            runner = svc.runner_for(L)
            x = runner.pack_batch(a[None])[0]
            b_p = runner.plan.codec.pack_b(b_c[i])
            for _ in range(k):
                x = runner.plan.step(x, b_p)
            want = runner.plan.unpack(x)
            bitwise = bitwise and got.shape == want.shape and torch.equal(
                torch.view_as_real(got).view(torch.int32),
                torch.view_as_real(want).view(torch.int32))
        row = {"row": "service", "mode": mode, "completed": snap["completed"],
               "dispatches": snap["dispatches"], "iterations": snap["iterations"],
               "midchain_admits": snap["midchain_admits"], "launches": counts,
               "dispatch_wall_ms": snap["busy_s"] / max(1, snap["dispatches"]) * 1e3,
               "stream_wall_ms": wall_s * 1e3, "bitwise_vs_chained_steps": bitwise}
        expected = {"batch": "su3_mult_planar", "continuous": "su3_mult_planar",
                    "megakernel": "su3_mult_planar_batched"}[mode]
        ok = (snap["completed"] == len(requests) and bitwise
              and counts[expected] == snap["dispatches"]
              and sum(counts.values()) == counts[expected])
        if mode == "megakernel":
            mega_launches = counts["su3_mult_planar_batched"]
            row["table_grew_in_flight"] = grew
            ok = ok and grew
            table = svc._tables[0][1]
            ks1 = [1] * table.slots
            row["megakernel_ms_per_launch"] = _time_ms(lambda: table.advance(ks1), reps=20)
        # -- a stencil batch and a solve at L=32: counts from 0 ------------------
        torch.cuda.synchronize()
        _reset_counts()
        before_iters = snap["kind_iterations"].get("solve", 0)
        st_ids = [svc.submit_stencil(big[i], v_st[i]) for i in range(2)]
        cg_id = svc.submit_solve(u_cg, rhs_cg, tol=1e-6, max_iters=200)
        svc.run_until_drained()
        torch.cuda.synchronize()
        c2 = _counts()
        iters = svc.metrics.snapshot()["kind_iterations"]["solve"] - before_iters
        for name in side:
            side[name] += c2[name]
        plan = svc.runner_for(big_L).plan
        st_ok = all(torch.equal(
            torch.view_as_real(svc.pop_result(sid)).view(torch.int32),
            torch.view_as_real(plan.unpack_vec(plan.stencil_step()(
                plan.pack_gauge(big[i]), plan.pack_rhs(v_st[i])))).view(torch.int32))
            for i, sid in enumerate(st_ids))
        x_svc = svc.pop_result(cg_id)
        ref = plan.cg_solve(plan.pack_gauge(u_cg), plan.pack_rhs(rhs_cg), tol=1e-6)
        x_ref = plan.unpack_vec(ref.x_p)
        rel = (torch.linalg.vector_norm(x_svc - x_ref) / torch.linalg.vector_norm(x_ref)).item()
        row.update({"stencil_launches": c2["su3_stencil_planar"], "stencil_bitwise": st_ok,
                    "solve_iterations": iters, "cg_launches": c2["su3_cg_fused_planar"],
                    "cg_solve_iterations": ref.iterations, "solve_rel_diff": rel})
        ok = ok and st_ok and c2["su3_stencil_planar"] == 2 and \
            c2["su3_cg_fused_planar"] == iters and rel <= 1e-5
        row["ok"] = ok
        _emit(row)
        if not ok:
            failures.append(f"service {mode}: {row}")
        del svc, results
    _emit({"autotune": tuned, "cache": str(cache.relative_to(ROOT))})
    return mega_launches, side


def _megakernel_yardsticks(u, rng, hw) -> dict:
    """The megakernel on a full table of TABLE_SLOTS L=32 slots (SoA f32),
    in place, at uniform k=1 and k=8; its plain version and one batched
    complex64 ``torch.matmul`` step at k=1; the bound of each launch; and
    the cost of one small launch (the autotune model's launch term)."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.kernels import su3_matmul

    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    lattices = _slot_lattices(u, TABLE_SLOTS)
    b_c = torch.from_numpy(random_su3(rng, (TABLE_SLOTS, layouts.LINKS))).to(u.device)
    a = torch.stack([codec.pack(x) for x in lattices]).contiguous()
    b = torch.stack([codec.pack_b(x) for x in b_c]).contiguous()
    dev, n = u.device, u.shape[0]
    ks = {k: torch.full((TABLE_SLOTS,), k, dtype=torch.int32, device=dev) for k in (1, 8)}
    ms = {k: _time_ms(lambda k=k: su3_matmul.su3_mult_planar_batched(
        a, b, ks[k], tile=codec.tile, alias=True), reps=20) for k in (1, 8)}
    plain_ms = _time_ms(lambda: su3_matmul.su3_mult_planar_batched_plain(a, b, ks[1]), reps=2,
                        warmup=1)
    del a
    a_c = torch.stack(lattices)  # (slots, S, 4, 3, 3) complex64
    b_m = b_c[:, None].contiguous()  # (slots, 1, 4, 3, 3)
    library_ms = _time_ms(lambda: torch.matmul(a_c, b_m), reps=3, warmup=1)
    del a_c, lattices
    # the launch cost: one 256-site slot, in place, host clock and events
    a_t = torch.zeros((1, 2, 36, 256), device=dev)
    b_t, k_t = torch.zeros((1, 2, 36), device=dev), torch.ones(1, dtype=torch.int32, device=dev)
    launch = lambda: su3_matmul.su3_mult_planar_batched(a_t, b_t, k_t, tile=256, alias=True)  # noqa: E731
    event_us = _time_ms(launch, reps=200, warmup=20) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        launch()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    bounds = {k: roofline.megakernel_bound([k] * TABLE_SLOTS, n_sites=n, hw=hw) if hw else None
              for k in (1, 8)}
    out = {"yardstick": f"su3_mult_planar_batched soa f32 L=32, {TABLE_SLOTS} slots, in place",
           "k1_ms": ms[1], "k8_ms": ms[8], "plain_k1_ms": plain_ms, "library_k1_ms": library_ms,
           "library_call": "torch.matmul((8,S,4,3,3) c64, (8,1,4,3,3) c64)",
           "launch_cost_us": {"host": host_us, "events": event_us}}
    if hw is not None:
        out.update({f"k{k}_bound_ms": bnd.bound_s * 1e3 for k, bnd in bounds.items()})
        out.update({f"k{k}_bound_by": bnd.bound_by for k, bnd in bounds.items()})
        out.update({f"k{k}_bound_share": bounds[k].bound_s * 1e3 / ms[k] for k in ms})
    _emit(out)
    bound = bounds[1]
    return {"ms": ms[1], "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": None if bound is None else bound.bound_s * 1e3,
            "bound_by": None if bound is None else bound.bound_by}


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
