#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SU3_Bench and its LM serving path on one
NVIDIA card and check it.

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
    the same lattice split into 2 and 4 t-slabs (``MeshSpec`` plans):
    first-touch init and ``step``, the overlapped ``stencil_step`` at depth
    1 and 2, and ``cg_solve(fused=True, overlap=True)``, each bitwise
    against the serial and one-slab paths, with the kernels' boundary and
    ring launches held against their plain versions, the halo faults, the
    times and phase split, the stencil and CG tuners at 2 slabs and the
    attribution of the traced steps; and ``SU3Service`` in its batch,
    continuous and megakernel modes on one seeded request stream
    (multiplies at L=16 and L=32, then a stencil batch and a solve),
    autotuned against a fresh cache under ``build/``;
  * the LM phase: holds the flash-attention kernel against its plain
    version in nine forms (f32 and bf16, causal and not, G in {1, 4, 8},
    D in {32, 64, 128}, ragged lengths, Sq != Skv, q_offset); drives
    ``ServeEngine`` on full-width qwen3-4b (random bf16 weights from
    ``--seed``) over 4 prompts of 1,024 tokens plus 32 greedy tokens, with
    the counters set to 0 just before and read just after (36 flash launches
    in prefill, none in decode); holds the decode logits against a
    teacher-forced prefill, and the card against the port's CPU path at 2
    layers in f32;
  * the training phase: holds the flash backward kernel against its plain
    version in nine forms (and twice bitwise; one reads a strided dout in
    place), and the forward's ``out`` with and without lse; trains
    full-width qwen3-4b (36 layers, f32 master weights and AdamW moments,
    bf16 compute, remat) through
    ``train.loop.train`` for 5 steps on 2 x 1,024 tokens from the seeded
    ``TokenPipeline``, with the counters set to 0 just before and read just
    after (72 flash forward launches a step, 36 in the remat recompute; 36
    backward calls); profiles one more step; holds one step's loss and
    gradients on the card against the CPU at 2 layers in f32, and 4 steps
    straight against 2 + checkpoint + restore + 2, bitwise, on the card;
  * the MoE phase, after the qwen3-4b phases have freed the card: on
    full-width, full-depth granite-moe-1b-a400m (24 layers, 32 experts
    top-8, 16/8 heads of 64), ``ServeEngine`` as above (24 flash launches in
    prefill, none in decode; decode against a teacher-forced forward with
    capacity for every assignment and expert choices pinned to the
    teacher's, the served config's drops, flips and difference printed;
    the card against the CPU at 2 layers in f32 with equal routing;
    matrices at std 0.02, see ``_matrices_at``) and ``train.loop.train`` as above (48
    flash forward and 24 backward launches a step; ``nll`` and ``aux`` per
    step; one step twice from one state, bitwise; card against CPU at 2
    layers with equal routing; resume bitwise); then the flash forward and
    backward at its head dim 64 and G = 2 against their plain versions,
    timed beside SDPA and their bounds;
  * times each kernel against its bound, its plain version and, where one
    PyTorch call computes the same function, that call (every time in the
    kernels line from eager calls; the flash kernel and SDPA also in a CUDA
    graph of back-to-back calls, printed beside them, where the wrapper's
    host cost does not show).

It prints:

  * the card's name and power limit (nvidia-smi) and the tool versions;
  * the HGMMA, UTMALDG and HMMA counts of the built flash-attention library
    (``cuobjdump -sass``): its bf16 body must run wgmma fed by TMA; and the
    HGMMA count of each bf16 backward kernel (dK/dV and dQ, every head dim
    and mask), which must run wgmma too;
  * one JSON line per check, per main-path row and per yardstick;
  * a ``{"kernels": [...]}`` line with each ported kernel's numbers (the
    flash backward beside the forward);
  * last, ``{"ok": true, "device": {...}}`` — only if every phase passed.

The whole output is over 20 KB; where only the end of a log is kept, run
``mkdir -p build && python3 chip_smoke.py | tee build/chip_smoke.log`` to
keep all of it.  Without CUDA, or without the rest of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import re
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
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:69"  # flash_attention_tpu (pallas_call :92)
LM_ARCH = "qwen3-4b"  # full width: 36 layers, d_model 2560, 32/8 heads of 128, vocab 151,936
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32  # 4 prompts of 1,024 tokens, 32 greedy tokens
LM_MAX_LEN = 1064
# decode logits against a teacher-forced prefill, bf16 at full depth: every
# op rounds to bf16 (2^-9 relative), the two paths round in other places and
# other matmul shapes over 36 residual layers; logits are O(1), so a wrong
# cache row or position moves them by O(1), far past 0.1 of their range
LM_TEACHER_TOL = 0.1
# the card against the port's CPU path at 2 layers in f32, TF32 off: sums in
# another order (cuBLAS against the CPU's BLAS, the kernel's 64-key tiles
# against 1,024-key chunks), ~1e-6 relative per op on O(1) logits
LM_CROSS_TOL = 1e-3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 5  # 2 x 1,024 tokens a step, 5 steps
# the MoE phase, served and trained at the LM and training shapes above: full
# width, 24 layers, d_model 1,024, 16/8 heads of 64, 32 experts top-8 (d_ff
# 512), vocab 49,155, tied embeddings; 1.33 B parameters, 0.40 B active
MOE_ARCH = "granite-moe-1b-a400m"
# step 1's loss against ln(vocab): the init's 0.02 embedding (tied) gives
# logits of ~1e-2, a near-uniform softmax
TRAIN_START_TOL = 1.0
# one train step's loss and gradients, the card against the CPU at 2 layers
# in f32, TF32 off: sums in another order (cuBLAS and the kernels' tiles
# against the CPU's BLAS and 512 / 1,024-row chunks), ~1e-6 relative per op;
# an element near zero carries the rounding of the terms that cancelled in
# it, so each gradient is held against its largest magnitude
TRAIN_CROSS_LOSS_TOL = 1e-4
TRAIN_CROSS_GRAD_TOL = 1e-3
TRAIN_CROSS_SEQ = 128
# the backward replaces the reference's autodiff of its chunked attention:
# flash_attention_tpu (FLASH_REPLACES) has no backward
BWD_SOURCE_LINE = "src/repro/models/attention.py:52"
BWD_FORMS = [  # (label, batch, sq, skv, hq, hkv, d, causal, q_offset, dtype)
    ("training shape bf16 causal", 2, 1024, 1024, 32, 8, 128, True, 0, "bfloat16"),
    ("training shape f32 causal", 2, 1024, 1024, 32, 8, 128, True, 0, "float32"),
    ("ragged 100 G=4 D=64 bf16", 1, 100, 100, 4, 1, 64, True, 0, "bfloat16"),
    ("ragged 100 G=1 D=32 f32 non-causal", 1, 100, 100, 4, 4, 32, False, 0, "float32"),
    ("Sq<Skv q_offset 136 G=4 D=64 f32", 2, 64, 200, 8, 2, 64, True, 136, "float32"),
    ("Sq<Skv q_offset 136 G=4 D=32 bf16", 2, 64, 200, 8, 2, 32, True, 136, "bfloat16"),
    ("Sq<Skv G=1 D=64 bf16 non-causal", 1, 64, 200, 4, 4, 64, False, 0, "bfloat16"),
    ("ragged 130 G=4 D=128 f32", 1, 130, 130, 8, 2, 128, True, 0, "float32"),
    # dout a slice of a (B, S, Hq, 2 D) tensor: 16-byte rows, read in place
    ("G=4 D=128 bf16 causal dout strided", 1, 512, 512, 16, 4, 128, True, 0, "bfloat16"),
]
BWD_TC_KERNELS = ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")  # the bf16 backward's wgmma kernels
FLASH_FORMS = [  # (label, batch, sq, skv, hq, hkv, d, causal, q_offset, dtype)
    ("main path bf16 causal", 4, 1024, 1024, 32, 8, 128, True, 0, "bfloat16"),
    ("main path f32 causal", 4, 1024, 1024, 32, 8, 128, True, 0, "float32"),
    ("main path bf16 non-causal", 4, 1024, 1024, 32, 8, 128, False, 0, "bfloat16"),
    ("G=1 D=64 f32", 2, 512, 512, 8, 8, 64, True, 0, "float32"),
    ("G=8 D=32 bf16", 2, 512, 512, 16, 2, 32, True, 0, "bfloat16"),
    ("G=8 D=128 f32 ragged 333", 1, 333, 333, 32, 4, 128, True, 0, "float32"),
    ("ragged 1000 bf16", 1, 1000, 1000, 32, 8, 128, True, 0, "bfloat16"),
    ("Sq!=Skv non-causal f32 D=64", 2, 300, 700, 16, 4, 64, False, 0, "float32"),
    ("q_offset 1024 bf16", 2, 64, 1088, 32, 8, 128, True, 1024, "bfloat16"),
]


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _tool_line(cmd: list[str]) -> str:
    out = _tool_output(cmd).strip()
    return out.splitlines()[-1] if out else ""


def _tool_output(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout


def _sass_per_function(listing: str, op: str) -> dict[str, int]:
    """The count of instruction ``op`` in each function of a ``cuobjdump
    -sass`` listing, keyed by the function's (mangled) name."""
    counts: dict[str, int] = {}
    name = None
    for line in listing.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name is not None and re.search(rf"\b{op}\b", line):
            counts[name] += 1
    return counts


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


def _graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device ms per call: ``calls`` back-to-back calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events, so that
    the host's cost per call does not show."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


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
    from repro_torch.kernels import flash_attention, su3_matmul, su3_stencil

    return (su3_matmul.LAUNCHES, su3_matmul.MEGA_LAUNCHES, su3_stencil.STENCIL_LAUNCHES,
            su3_stencil.CG_LAUNCHES, flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)


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
    from repro_torch.kernels import _build, flash_attention, su3_matmul, su3_stencil

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
    _build.load("flash_attention")
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
    flash_forms = []
    for dtype, body in (("float32", "cuda cores"), ("bfloat16", "tensor cores")):
        for d in flash_attention.HEAD_DIMS:
            for causal in (True, False):
                b = flash_attention.kernel_budget(getattr(torch, dtype), d, causal)
                flash_forms.append([body, dtype, d, causal, b["num_regs"], b["local_bytes"],
                                    b["shared_bytes"], b["threads_per_block"],
                                    b["blocks_per_sm"], b["occupancy"]])
    _emit({"kernel_budget": "flash_attention",
           "columns": ["body", "dtype", "head_dim", "causal", "num_regs", "local_bytes",
                       "shared_bytes", "threads_per_block", "blocks_per_sm", "occupancy"],
           "forms": flash_forms})
    bwd_forms = []
    for dtype in ("float32", "bfloat16"):
        for d in flash_attention.HEAD_DIMS:
            for causal in (True, False):
                for kname, b in flash_attention.bwd_budget(getattr(torch, dtype), d,
                                                            causal).items():
                    bwd_forms.append([kname, dtype, d, causal, b["num_regs"], b["local_bytes"],
                                      b["shared_bytes"], b["threads_per_block"],
                                      b["blocks_per_sm"]])
                    if b["local_bytes"] or b["blocks_per_sm"] < 1:
                        failures.append(f"flash_attention_bwd {kname} {dtype} D={d}: {b}")
    _emit({"kernel_budget": "flash_attention_bwd",
           "columns": ["kernel", "dtype", "head_dim", "causal", "num_regs", "local_bytes",
                       "shared_bytes", "threads_per_block", "blocks_per_sm"],
           "forms": bwd_forms})
    # the bf16 body runs on the tensor cores: wgmma (HGMMA) fed by TMA (UTMALDG)
    sass = _tool_output([str(pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
                           str(_build.library_path("flash_attention"))])
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}
    _emit({"sass": "flash_attention", "instructions": counts})
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        failures.append(f"flash_attention: no HGMMA or UTMALDG in the built library: {counts}")
    # the bf16 backward on the tensor cores: HGMMA in each of its kernels
    per_fn = _sass_per_function(sass, "HGMMA")
    bwd_hgmma = {kname: {fn: n for fn, n in per_fn.items() if kname in fn}
                 for kname in BWD_TC_KERNELS}
    _emit({"sass": "flash_attention_bwd bf16", "HGMMA_per_function": {
        kname: sorted(found.values()) for kname, found in bwd_hgmma.items()}})
    for kname, found in bwd_hgmma.items():
        if len(found) != 2 * len(flash_attention.HEAD_DIMS) or not all(found.values()):
            failures.append(f"flash_attention_bwd: {kname} lacks HGMMA or instantiations: {found}")

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

    # -- 4e. the main path on 2 and 4 slabs: MeshSpec plans at PAPER_L32 -------------
    slabs = _multislab_phase(u, args.seed, hw, failures)
    main_path_launches += slabs[su3_matmul.LAUNCHES.name]
    stencil_launches += slabs[su3_stencil.STENCIL_LAUNCHES.name]
    cg_launches += slabs[su3_stencil.CG_LAUNCHES.name]
    if not all(slabs.values()):
        failures.append(f"the multi-slab main path left a kernel unlaunched: {slabs}")

    # -- 4f. the serving megakernel vs its plain version, L=32 slot tables ----------
    mega_err = _megakernel_checks(u, rng, failures)
    # -- 4g. the main path: SU3Service in its three dispatch modes --------------------
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
    torch.cuda.empty_cache()

    # -- 5b. the LM phase: the flash kernel, ServeEngine on qwen3-4b -----------------
    flash = _lm_phase(args.seed, hw, failures)

    # -- 5c. the training phase: the flash backward, training qwen3-4b -------------
    # full-width training needs ~70 GB of the card: free the SU3 phases' data
    del u, b_c, a, b, got, plain, vecs, codec, chained, x, in_place, aliased, b_mat, b16
    del engine
    torch.cuda.empty_cache()
    flash_bwd, train_fwd_launches = _train_phase(args.seed, hw, failures)
    flash["serve_launches"], flash["train_launches"] = flash["launches"], train_fwd_launches
    flash["launches"] += train_fwd_launches

    # -- 5d. the MoE phase: granite-moe served and trained, the kernels at D=64 ------
    torch.cuda.empty_cache()
    moe_launches = _moe_phase(args.seed, hw, failures)
    flash["moe_serve_launches"] = moe_launches["serve"]
    flash["moe_train_launches"] = moe_launches["train_fwd"]
    flash["launches"] += moe_launches["serve"] + moe_launches["train_fwd"]
    flash_bwd["moe_train_launches"] = moe_launches["train_bwd"]
    flash_bwd["launches"] += moe_launches["train_bwd"]

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
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, **flash,
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": BWD_SOURCE_LINE, **flash_bwd,
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


def _flash_checks(rng, failures: list[str]) -> float:
    """The flash kernel against its plain version on the card in every form
    of FLASH_FORMS, within ``kernel_tolerance`` (f32 summation order; one
    bf16 output rounding).  Returns the largest absolute error."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev, worst = torch.device("cuda"), 0.0
    for label, b, sq, skv, hq, hkv, d, causal, q_offset, dtype in FLASH_FORMS:
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, dt)
                   for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
        got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        diff = torch.abs(got.float() - want.float())
        err = diff.max().item()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (diff <= atol + rtol * torch.abs(want.float())).all())
        worst = max(worst, err)
        _emit({"check": "kernel_vs_plain", "kernel": "flash_attention", "form": label,
               "shape": [b, sq, skv, hq, hkv, d], "causal": causal, "q_offset": q_offset,
               "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            failures.append(f"flash_attention vs plain {label}: err {err}")
        del q, k, v, got, want, diff
    return worst


def _profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time between
    CUDA events, the device time summed over its kernels, the device's idle
    share of the wall, device ms and launches by kernel class, and the
    kernels that took the most device time (by name, ms).  Device time is
    None where the profiler records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731  (us -> ms)
    device_ms = sum(dev(e) for e in kernels) or None
    ranked = sorted(kernels, key=dev, reverse=True)[:top]
    by_class: dict[str, float] = {}
    launches_by_class: dict[str, int] = {}
    for e in kernels:
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + dev(e)
        launches_by_class[_kernel_class(e.key)] = \
            launches_by_class.get(_kernel_class(e.key), 0) + e.count
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": None if device_ms is None else max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches": sum(e.count for e in kernels),
            "device_ms_by_class": by_class, "launches_by_class": launches_by_class,
            "top_kernels": [[e.key[:60], dev(e), e.count] for e in ranked]}


def _kernel_class(name: str) -> str:
    """The port's kernels by name; cuBLAS's matrix products (``nvjet``,
    ``gemm``, ``cutlass``); every other kernel (elementwise passes,
    reductions, copies) as ``other``."""
    if "flash_bwd" in name:
        return "flash_attention_bwd"
    if "flash_attention" in name:
        return "flash_attention"
    if any(tag in name.lower() for tag in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    return "other"


def _lm_phase(seed: int, hw, failures: list[str]) -> dict:
    """The LM serving path on the card: the flash kernel's forms, then
    ``ServeEngine`` on full-width qwen3-4b (random bf16 weights from the
    seed) serving 4 x 1,024-token prompts + 32 greedy tokens, with the
    flash counter set to 0 just before and read just after; decode logits
    against a teacher-forced prefill; the card against the port's CPU path
    at 2 layers in f32; the kernel's yardsticks at the prefill shape.
    Returns the flash entry of the kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    rng = np.random.default_rng(seed + 14)
    max_err = _flash_checks(rng, failures)
    dev = torch.device("cuda")

    # -- the main path ------------------------------------------------------------
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg,
                                   torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    first_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts[fa.LAUNCHES.name]
    # the same call again, timed in steady state, with the peak memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(prompts, LM_NEW)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = engine.last_timings
    # prefill alone, then the 31 decode steps on the served tokens, through
    # the engine's own calls, each counted from 0
    toks_d = torch.from_numpy(tokens).to(dev)
    state = engine.init_state(LM_BATCH)
    _reset_counts()
    logits_p, state = engine.prefill({"tokens": toks_d[:, :LM_PROMPT]}, state)
    torch.cuda.synchronize()
    prefill_launches = _counts()[fa.LAUNCHES.name]
    step_logits = [logits_p]
    _reset_counts()
    for t in range(LM_NEW - 1):
        lg, state = engine.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], state,
                                  LM_PROMPT + t)
        step_logits.append(lg)
    torch.cuda.synchronize()
    decode_launches = _counts()[fa.LAUNCHES.name]
    # where the time goes: one prefill, and 4 decode steps from the filled cache
    prof_state = engine.init_state(LM_BATCH)
    prof_prefill = _profile(lambda: engine.prefill({"tokens": toks_d[:, :LM_PROMPT]}, prof_state))

    def four_steps():
        for t in range(4):
            engine.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], prof_state, LM_PROMPT + t)

    prof_decode = _profile(four_steps)
    _emit({"profile": "lm prefill (4 x 1,024 tokens)", **prof_prefill})
    _emit({"profile": "lm decode (4 steps)", **prof_decode})
    del prof_state
    served = torch.cat(step_logits, dim=1).float()  # (B, 32, V): positions 1023 .. 1054
    # teacher forcing: one prefill-style forward over prompt + generated tokens
    x, _, _ = transformer.forward(engine.params, {"tokens": toks_d[:, :-1]}, cfg,
                                  q_chunk=512, kv_chunk=1024)
    teacher = transformer._logits(engine.params, x[:, LM_PROMPT - 1:], cfg).float()
    torch.cuda.synchronize()
    diff = torch.abs(served - teacher)
    scale = torch.abs(teacher).max().item()
    teacher_err = diff.max().item()
    token_agree = float((served.argmax(-1) == teacher.argmax(-1)).float().mean().item())
    finite = bool(torch.isfinite(served).all()) and bool(torch.isfinite(teacher).all())
    new_tok = LM_BATCH * LM_NEW
    row = {"row": "lm serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": common.count_params(engine.params), "dtype": cfg.dtype,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "max_len": LM_MAX_LEN, "init_s": init_s, "first_generate_s": first_s,
           "flash_launches": launches, "expected_launches": cfg.n_layers,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "prefill_ms": tm["prefill_s"] * 1e3,
           "decode_ms_per_token": tm["decode_s"] * 1e3 / tm["decode_steps"],
           "generate_wall_ms": wall_s * 1e3, "new_tokens_per_s": new_tok / wall_s,
           "decode_tokens_per_s": LM_BATCH * tm["decode_steps"] / tm["decode_s"],
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / tm["prefill_s"],
           "peak_memory_GB": peak_gb, "same_tokens_twice": bool(np.array_equal(tokens, again)),
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "logits_finite": finite, "teacher_max_abs_diff": teacher_err,
           "teacher_mean_abs_diff": diff.mean().item(), "teacher_logit_scale": scale,
           "teacher_tol": LM_TEACHER_TOL * scale, "teacher_token_agreement": token_agree}
    row["ok"] = (launches == cfg.n_layers and prefill_launches == cfg.n_layers
                 and decode_launches == 0 and row["other_launches"] == 0 and finite
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
                 and teacher_err <= LM_TEACHER_TOL * scale)
    _emit(row)
    if not row["ok"]:
        failures.append(f"lm serve main path: {row}")
    del engine, model, state, x, teacher, served, step_logits, logits_p, diff
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, 2 layers, f32 ----------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _serve_cross_device("lm cross-device", cfg2,
                        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), rng,
                        failures)

    # -- yardsticks at the prefill shape ------------------------------------------------
    b, s, hq, hkv, d = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, torch.bfloat16)
               for shp in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    # eager calls, as for every other kernel; a CUDA graph of back-to-back
    # calls beside them, where the wrapper's host cost per call does not show
    kernel_ms = _time_ms(lambda: fa.flash_attention(q, k, v), reps=20)
    kernel_graph_ms = _graph_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    library_ms = _time_ms(sdpa, reps=20)
    library_graph_ms = _graph_ms(sdpa)
    lib_err = torch.abs(sdpa().transpose(1, 2).float() - fa.flash_attention(q, k, v).float())
    bound = roofline.attention_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d,
                                     dtype=torch.bfloat16, hw=hw) if hw is not None else None
    bound_f32 = roofline.attention_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d,
                                         dtype=torch.float32, hw=hw) if hw is not None else None
    executed = fa.executed_flops(b, s, s, hq, hkv, d)  # split PV and causal tile waste included
    _emit({"yardstick": f"flash_attention bf16 causal B={b} S={s} Hq={hq} Hkv={hkv} D={d}",
           "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_graph_ms": library_graph_ms,
           "timing": "*_ms: eager calls; *_graph_ms: CUDA graph of 20 calls",
           "library_call": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
           "library_max_abs_diff": lib_err.max().item(),
           "flops": None if bound is None else bound.flops,
           "bytes": None if bound is None else bound.bytes,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "fp32_core_bound_ms": None if bound_f32 is None else bound_f32.compute_s * 1e3,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9,
           "own_floor_ms": None if hw is None else executed / hw.peak_flops_bf16 * 1e3})
    return {"launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": None if bound is None else bound.bound_s * 1e3,
            "bound_by": None if bound is None else bound.bound_by, "library_ms": library_ms}


def _serve_cross_device(row_name: str, cfg2, model2, rng, failures: list[str]) -> None:
    """The card against the port's CPU path on ``model2`` (``cfg2`` in f32,
    TF32 off): 8 greedy tokens after a 64-token prompt on each, then the
    CPU's tokens prefilled and decoded on both: logits within LM_CROSS_TOL
    and every MoE layer's expert choices (``moe._route``) equal."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import moe, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cpu = ServeEngine(cfg2, copy.deepcopy(model2), ServeConfig(max_len=80), device="cpu")
    card = ServeEngine(cfg2, model2, ServeConfig(max_len=80), device=torch.device("cuda"))
    prompt2 = rng.integers(0, cfg2.vocab_size, (1, 64), dtype=np.int32)
    cpu_tokens = cpu.generate(prompt2, 8)
    card_tokens = card.generate(prompt2, 8)
    logits, routes = [], []
    for eng in (cpu, card):
        t = torch.from_numpy(cpu_tokens).to(eng.device)
        st = eng.init_state(1)
        routes.append([])
        with _wrapped(moe, "_route", _recording_routes(routes[-1])):
            lg, st = eng.prefill({"tokens": t[:, :64]}, st)
            out = [lg]
            for i in range(7):
                lg, st = eng.decode(t[:, 64 + i:65 + i], st, 64 + i)
                out.append(lg)
        logits.append(torch.cat(out, dim=1).float().cpu())
    err = torch.abs(logits[0] - logits[1]).max().item()
    n_moe = transformer.stack_sizes(cfg2).get("moe_layers", 0)
    same_routes = len(routes[0]) == len(routes[1]) == 8 * n_moe and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(*routes))
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "tf32": torch.backends.cuda.matmul.allow_tf32, "prompt": 64, "new_tokens": 8,
           "max_abs_logit_diff": err, "tol": LM_CROSS_TOL,
           "logit_scale": logits[0].abs().max().item(), "routes_compared": len(routes[0]),
           "same_routes": same_routes, "same_tokens": bool(np.array_equal(cpu_tokens, card_tokens))}
    row["ok"] = err <= LM_CROSS_TOL and same_routes and not row["tf32"]
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")


def _train_cross_device(row_name: str, cfg2, model, seed: int, failures: list[str]) -> None:
    """One step's loss and gradients on ``model`` (trainable, on the CPU;
    ``cfg2`` in f32), the card against the CPU on TRAIN_BATCH x
    TRAIN_CROSS_SEQ seeded tokens, TF32 off: the loss within
    TRAIN_CROSS_LOSS_TOL (relative), each gradient within
    TRAIN_CROSS_GRAD_TOL of its leaf's largest magnitude (an element near
    zero carries the rounding of the terms that cancelled in it), and every
    MoE layer's expert choices (forward and remat recompute) equal."""
    import copy

    import torch

    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.models import moe, transformer
    from repro_torch.train import train_step

    card_model = copy.deepcopy(model).to(torch.device("cuda"))
    pipe = TokenPipeline(DataConfig(cfg2.vocab_size, TRAIN_CROSS_SEQ, TRAIN_BATCH, seed=seed))
    found, routes = {}, {}
    for name, m in (("cpu", model), ("card", card_model)):
        batch, _ = make_train_batch(pipe, PipelineState(), cfg2, device=next(m.parameters()).device)
        routes[name] = []
        with _wrapped(moe, "_route", _recording_routes(routes[name])):
            grads, metrics = train_step.make_grad_fn(cfg2, q_chunk=TRAIN_CROSS_SEQ,
                                                     kv_chunk=TRAIN_CROSS_SEQ)(m, batch)
        found[name] = ({n: g.cpu() for n, g in grads.items()},
                       {k: v.item() for k, v in metrics.items()})
        del grads
    del model, card_model
    (g_cpu, m_cpu), (g_card, m_card) = found["cpu"], found["card"]
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    leaf_errs = {n: (g_card[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                 for n, g in g_cpu.items()}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    router_errs = [e for n, e in leaf_errs.items() if n.endswith("moe.router")]
    n_moe = transformer.stack_sizes(cfg2).get("moe_layers", 0)
    same_routes = len(routes["cpu"]) == len(routes["card"]) == 2 * n_moe and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(routes["cpu"], routes["card"]))
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "tf32": torch.backends.cuda.matmul.allow_tf32, "batch": TRAIN_BATCH,
           "seq": TRAIN_CROSS_SEQ, "loss_cpu": m_cpu["loss"], "loss_card": m_card["loss"],
           "aux_cpu": m_cpu["aux"], "aux_card": m_card["aux"], "loss_rel_diff": loss_rel,
           "loss_tol": TRAIN_CROSS_LOSS_TOL, "leaves": len(leaf_errs), "worst_leaf": worst_leaf,
           "worst_leaf_err_of_max": leaf_errs[worst_leaf],
           "router_err_of_max": max(router_errs) if router_errs else None,
           "grad_tol_of_max": TRAIN_CROSS_GRAD_TOL, "routes_compared": len(routes["cpu"]),
           "same_routes": same_routes}
    row["ok"] = (loss_rel <= TRAIN_CROSS_LOSS_TOL and not row["tf32"] and same_routes
                 and leaf_errs[worst_leaf] <= TRAIN_CROSS_GRAD_TOL)
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")


def _resume_check(row_name: str, cfg2, seed: int, failures: list[str]) -> None:
    """``train.loop.train`` on ``cfg2`` on the card: 4 steps straight
    against 2 steps + checkpoint (under ``build/``) + restore + 2: losses,
    aux, parameters and moments bitwise."""
    import shutil

    import torch

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    dev = torch.device("cuda")
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    quiet = lambda line: None  # noqa: E731

    def resume_cfg(n: int, directory: str | None):
        return loop.TrainConfig(steps=n, seq_len=TRAIN_CROSS_SEQ, global_batch=TRAIN_BATCH,
                                log_every=1, seed=seed, checkpoint_dir=directory,
                                checkpoint_every=100,
                                opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=4))

    t0 = time.perf_counter()
    straight = loop.train(cfg2, resume_cfg(4, None), log=quiet, device=dev)
    first_hist = loop.train(cfg2, resume_cfg(2, str(ckpt_dir)), log=quiet, device=dev)["history"]
    torch.cuda.empty_cache()
    resumed = loop.train(cfg2, resume_cfg(4, str(ckpt_dir)), log=quiet, device=dev)
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        straight["params"].named_parameters(), resumed["params"].named_parameters()))
    same_moments = all(torch.equal(straight["opt_state"][k][n], resumed["opt_state"][k][n])
                       for k in ("m", "v") for n in straight["opt_state"][k])
    curves = {key: ([h[key] for h in straight["history"]],
                    [h[key] for h in first_hist + resumed["history"]]) for key in ("loss", "aux")}
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "losses_straight": curves["loss"][0], "losses_resumed": curves["loss"][1],
           "aux_straight": curves["aux"][0], "aux_resumed": curves["aux"][1],
           "params_bitwise": same_params, "moments_bitwise": same_moments,
           "seconds": time.perf_counter() - t0}
    row["ok"] = same_params and same_moments and all(a == b for a, b in curves.values())
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")
    del straight, resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def _bwd_checks(rng, failures: list[str]) -> float:
    """The flash backward kernel against its plain version on the card in
    every form of BWD_FORMS, within ``kernel_tolerance`` scaled to each
    gradient's largest magnitude (``flash_attention.kernel_tolerance``
    states the rule); each form twice, bitwise; the forward's ``out`` with
    lse against without it (bitwise) and its lse against the plain
    version's (within 1e-5 + 1e-5 relative: f32 sums in another order).
    Returns the largest absolute error of dq, dk and dv."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev, worst = torch.device("cuda"), 0.0
    for label, b, sq, skv, hq, hkv, d, causal, q_offset, dtype in BWD_FORMS:
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, dt)
                         for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                     (b, sq, hq, d)))
        if label.endswith("dout strided"):
            wide = torch.zeros((b, sq, hq, 2 * d), dtype=dt, device=dev)
            wide[..., :d] = dout
            dout = wide[..., :d]
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_offset)
        bare, _ = fa._forward(q, k, v, with_lse=False, **kw)
        out, lse = fa._forward(q, k, v, with_lse=True, **kw)
        _, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        row = {"check": "kernel_vs_plain", "kernel": "flash_attention_bwd", "form": label,
               "shape": [b, sq, skv, hq, hkv, d], "causal": causal, "q_offset": q_offset,
               "dtype": dtype, "dout_strides": list(dout.stride()), "atol": atol,
               "rtol_of_max": rtol}
        ok = True
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
            row[f"{name}_max_abs_err"], row[f"{name}_max"] = err, scale
            row[f"{name}_share_of_limit"] = err / (atol + rtol * scale)
            ok = ok and err <= atol + rtol * scale and bool(torch.isfinite(g.float()).all())
            worst = max(worst, err)
        row["bitwise_twice"] = all(torch.equal(x, y) for x, y in zip(got, again))
        row["out_bitwise_with_lse"] = torch.equal(out, bare)
        lse_diff = (lse - lse_plain).abs()
        row["lse_max_abs_err"] = lse_diff.max().item()
        lse_ok = bool((lse_diff <= 1e-5 + 1e-5 * lse_plain.abs()).all())
        row["ok"] = ok and row["bitwise_twice"] and row["out_bitwise_with_lse"] and lse_ok
        _emit(row)
        if not row["ok"]:
            failures.append(f"flash_attention_bwd vs plain {label}: {row}")
        del q, k, v, dout, bare, out, lse, lse_plain, got, again, want
    return worst


def _train_phase(seed: int, hw, failures: list[str]) -> tuple[dict, int]:
    """The training path on the card: the backward kernel's checks; then
    ``train.loop.train`` on full-width, full-depth qwen3-4b (f32 master
    weights and moments, bf16 compute, remat; ~68 GB of the card) for
    TRAIN_STEPS steps with the counters set to 0 just before and read just
    after; one more step profiled, and one split into gradients and
    optimizer; one step's
    loss and gradients, the card against the CPU, at 2 layers in f32; 4
    steps straight against 2 + checkpoint + restore + 2, bitwise, on the
    card; the backward's yardsticks at the training shape.  Returns the
    backward's entry of the kernels line and the forward launches of the
    training run."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import roofline
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop, train_step

    rng = np.random.default_rng(seed + 17)
    max_err = _bwd_checks(rng, failures)
    dev = torch.device("cuda")
    base = get_config(LM_ARCH)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            log_every=1, seed=seed, opt=opt)

    # -- the main path: full width and depth ----------------------------------------------
    cfg, log_lines = base, []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = loop.train(cfg, tcfg, log=log_lines.append, device=dev)
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = counts[fa.LAUNCHES.name], counts[fa.BWD_LAUNCHES.name]
    for line in log_lines:
        print(f"train: {line}")
    hist, step_ms = out["history"], out["step_ms"]
    for h, ms in zip(hist, step_ms):
        _emit({"train_step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
               "lr": h["lr"], "step_ms": ms})
    params, opt_state = out["params"], out["opt_state"]
    del out
    n_params = common.count_params(params)
    # where the time goes: one more step under the profiler
    step_fn = train_step.make_train_step(cfg, opt, q_chunk=512, kv_chunk=1024)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed))
    batch, _ = make_train_batch(pipe, PipelineState(step=TRAIN_STEPS), cfg, device=dev)
    prof = _profile(lambda: step_fn(params, opt_state, batch), top=10)
    _emit({"profile": f"lm train step ({TRAIN_BATCH} x {TRAIN_SEQ} tokens)", **prof})
    # the step split, unprofiled: gradients (forward, remat recompute, backward)
    # and then the optimizer, between CUDA events
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=512, kv_chunk=1024)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    grads, _ = grad_fn(params, batch)
    marks[1].record()
    adamw.update(grads, opt_state, params, opt)
    marks[2].record()
    torch.cuda.synchronize()
    grad_ms, opt_ms = marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
    del params, opt_state, batch, step_fn, grads
    torch.cuda.empty_cache()

    losses, gnorms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    start = math.log(cfg.vocab_size)
    median_ms = float(np.median(step_ms[1:]))
    steps = len(hist)
    row = {"row": "lm train", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
           "master_dtype": "float32", "moment_dtype": opt.moment_dtype,
           "compute_dtype": cfg.dtype, "remat": True, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": steps, "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "step_ms_median_2_5": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
           "split_grad_ms": grad_ms, "split_optimizer_ms": opt_ms,
           "peak_memory_GB": peak_gb, "wall_s": wall_s,
           "flash_launches": fwd, "flash_bwd_launches": bwd,
           "flash_launches_per_step": fwd / steps, "flash_bwd_launches_per_step": bwd / steps,
           "expected_per_step": [2 * cfg.n_layers, cfg.n_layers],
           "other_launches": sum(counts.values()) - fwd - bwd,
           "idle_share": prof["idle_share"], "start_loss_target": start,
           "start_loss_tol": TRAIN_START_TOL}
    row["ok"] = (steps == TRAIN_STEPS and all(math.isfinite(x) for x in losses + gnorms)
                 and abs(losses[0] - start) <= TRAIN_START_TOL
                 and fwd == 2 * cfg.n_layers * steps and bwd == cfg.n_layers * steps
                 and row["other_launches"] == 0)
    _emit(row)
    if not row["ok"]:
        failures.append(f"lm train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, 2 layers, f32 -------
    cfg2 = dataclasses.replace(base, n_layers=2, dtype="float32")
    _train_cross_device("lm train cross-device", cfg2, common.trainable(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2)), seed, failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("lm train resume", cfg2, seed, failures)

    # -- yardsticks at the training shape ------------------------------------------------
    b, s, hq, hkv, d = TRAIN_BATCH, TRAIN_SEQ, base.n_heads, base.n_kv_heads, base.head_dim
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(
        dev, torch.bfloat16) for shp in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                                         (b, s, hq, d)))
    o, lse = fa._forward(q, k, v, causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                         with_lse=True)
    kernel_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse), reps=50)
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, dout, lse), reps=3,
                        warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dout.transpose(1, 2),  # noqa: E731
                                           retain_graph=True)
    library_ms = _time_ms(sdpa_bwd, reps=50)
    lib_dq = sdpa_bwd()[0].transpose(1, 2).float()
    lib_diff = (lib_dq - fa.flash_attention_bwd(q, k, v, o, dout, lse)[0].float()).abs().max()
    bound = roofline.attention_bwd_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d,
                                         dtype=torch.bfloat16, hw=hw) if hw is not None else None
    fp32_bound = roofline.attention_bwd_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d,
                                              dtype=torch.float32, hw=hw) if hw else None
    # the three kernels of a call (delta, dK/dV, dQ): device ms per call by
    # name, over 10 calls
    split = _profile(lambda: [fa.flash_attention_bwd(q, k, v, o, dout, lse) for _ in range(10)],
                     top=3)["top_kernels"]
    executed = fa.bwd_executed_flops(b, s, s, hq, hkv, d)  # 10 products, causal tile waste
    _emit({"yardstick": f"flash_attention_bwd bf16 causal B={b} S={s} Hq={hq} Hkv={hkv} D={d}",
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "backward of F.scaled_dot_product_attention(is_causal=True, "
                           "enable_gqa=True) (torch.autograd.grad)",
           "library_dq_max_abs_diff": lib_diff.item(),
           "flops": None if bound is None else bound.flops,
           "bytes": None if bound is None else bound.bytes,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "fp32_core_bound_ms": None if fp32_bound is None else fp32_bound.compute_s * 1e3,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "kernel_vs_library": kernel_ms / library_ms,
           "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9,
           "own_floor_ms": None if hw is None else executed / hw.peak_flops_bf16 * 1e3,
           "kernel_split_ms": {name: ms / count for name, ms, count in split}})
    return ({"launches": bwd, "launches_per_step": bwd / steps, "max_abs_err": max_err,
             "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": None if bound is None else bound.bound_s * 1e3,
             "bound_by": None if bound is None else bound.bound_by,
             "library_ms": library_ms}, fwd)


@contextlib.contextmanager
def _wrapped(owner, name: str, make):
    """Within the block ``owner.name`` is ``make(original)``."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _counting_drops(sink: list):
    """A wrapper of ``moe._dispatch_indices`` that appends each call's count
    of dropped assignments (past their expert's capacity) to ``sink``, as a
    device tensor."""
    def make(inner):
        def counted(idx, n_tokens, cfg, cap):
            tok, ks = inner(idx, n_tokens, cfg, cap)
            sink.append(idx.numel() - (tok < n_tokens).sum())
            return tok, ks
        return counted
    return make


def _recording_routes(sink: list):
    """A wrapper of ``moe._route`` that appends each call's top-k indices
    to ``sink``."""
    def make(inner):
        def recorded(params, x, cfg):
            out = inner(params, x, cfg)
            sink.append(out[1])
            return out
        return recorded
    return make


def _matrices_at(model, std: float, seed: int):
    """Redraw every matrix of ``model`` (each parameter of 2 or more dims)
    from N(0, std^2), in place, from a generator on its device seeded by
    ``seed``; norms and biases keep their values.  Returns ``model``.

    The MoE phase's checks run granite-moe at std 0.02 (GPT-2's rule, which
    the reference's embeddings and router already follow).  The reference's
    rule, 1/sqrt(shape[0]) (the layer count for a stacked leaf), gives
    granite-moe, which has no qk-norm, attention logits of std ~d_model
    std^2 (~40 at full depth, ~500 at a 2-layer cut): a saturated softmax
    whose near-ties amplify rounding, so that the card and the CPU (f32)
    and two bf16 passes part by more than the rounding of one op."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                gen = torch.Generator(device=p.device).manual_seed(seed)
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
                seed += 1
    return model


def _pinned_routes(routes: list, n_layers: int, flips: list):
    """A wrapper of ``moe._route`` (softmax routing) that takes each call's
    expert choices from ``routes``, a teacher-forced pass's (B, S, k)
    indices per layer: the calls run layer by layer, first a prefill of
    LM_PROMPT tokens, then one token a step.  The weights are the call's
    own router probabilities at those choices; ``flips`` gets each call's
    count of tokens whose own top-k differs."""
    import itertools

    import torch

    def make(inner):
        calls = itertools.count()

        def pinned(params, x, cfg):
            _, idx, aux = inner(params, x, cfg)
            step, layer = divmod(next(calls), n_layers)
            start = 0 if step == 0 else LM_PROMPT + step - 1
            want = routes[layer][:, start:start + x.shape[1]]
            flips.append((idx != want).any(-1).sum())
            probs = torch.softmax(torch.matmul(x.float(), params["router"].float()), dim=-1)
            top = torch.gather(probs, -1, want)
            w = top / torch.clamp_min(torch.sum(top, dim=-1, keepdim=True), 1e-9)
            return w.to(x.dtype), want, aux
        return pinned
    return make


def _moe_phase(seed: int, hw, failures: list[str]) -> dict[str, int]:
    """The MoE family on the card at granite-moe-1b-a400m's full width and
    depth: serving (``_moe_serve``), training (``_moe_train``) and the flash
    kernels at its head dim 64, G = 2 (``_moe_yardsticks``).  Returns the
    flash launches of its main paths: ``serve``, ``train_fwd``, ``train_bwd``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 19)
    serve = _moe_serve(seed, rng, failures)
    torch.cuda.empty_cache()
    train_fwd, train_bwd = _moe_train(seed, failures)
    torch.cuda.empty_cache()
    _moe_yardsticks(rng, hw, failures)
    return {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd}


def _moe_serve(seed: int, rng, failures: list[str]) -> int:
    """``ServeEngine`` on full-width granite-moe (random bf16 weights from
    the seed, f32 KV cache) over 4 x 1,024-token prompts + 32 greedy tokens,
    the flash counter set to 0 just before and read just after (24 launches
    in prefill, 0 in decode); decode logits against a teacher-forced
    forward on the same weights with capacity for every assignment and the
    decode path's expert choices pinned to the teacher's (the served
    config's difference, the capacity drops of both passes and the routing
    flips printed beside it); the card against the port's CPU path at 2
    layers in f32, routing equal.  Matrices at std 0.02 (``_matrices_at``).
    Returns the flash launches of the served generate."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, moe, registry, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    first_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts[fa.LAUNCHES.name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(prompts, LM_NEW)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = engine.last_timings
    # decode logits against a teacher-forced forward over prompt + generated
    # tokens, through the engine's own calls (prefill, then the 31 decode
    # steps, each counted from 0), with the capacity drops of both passes
    # counted.  Two things differ between the paths besides what the check
    # is for (the cache, the positions, the kernels):
    # * capacity is per group: 320 slots an expert in the 1,024-token
    #   prefill, 330 in the 1,055-token teacher pass, 1 (never full) in
    #   decode, so wherever an expert overflows the paths drop different
    #   assignments;
    # * bf16 rounds the router's inputs otherwise in the two paths, and a
    #   token whose 8th and 9th experts nearly tie changes expert.
    # The check is held on the same weights with capacity for every
    # assignment (capacity factor E / k: no pass drops one) and each decode
    # call's expert choices pinned to the teacher pass's (weights from its
    # own router); the flips that pinning undid, and the served config's
    # own difference, are printed beside it.
    toks_d = torch.from_numpy(tokens).to(dev)
    dropless = ServeEngine(dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                               / cfg.experts_per_token),
                           engine.params, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    found = {}
    for name, eng in (("served", engine), ("dropless pinned", dropless)):
        drops: dict[str, list] = {"prefill": [], "teacher": []}
        routes: list = []
        with _wrapped(moe, "_dispatch_indices", _counting_drops(drops["teacher"])), \
                _wrapped(moe, "_route", _recording_routes(routes)):
            x, _, _ = transformer.forward(eng.params, {"tokens": toks_d[:, :-1]}, eng.cfg,
                                          q_chunk=512, kv_chunk=1024)
        teacher = transformer._logits(eng.params, x[:, LM_PROMPT - 1:], eng.cfg).float()
        del x
        flips: list = []
        pin = (_wrapped(moe, "_route", _pinned_routes(routes, cfg.n_layers, flips))
               if eng is dropless else contextlib.nullcontext())
        state = eng.init_state(LM_BATCH)
        with pin:
            _reset_counts()
            with _wrapped(moe, "_dispatch_indices", _counting_drops(drops["prefill"])):
                lg, state = eng.prefill({"tokens": toks_d[:, :LM_PROMPT]}, state)
            torch.cuda.synchronize()
            prefill_launches = _counts()[fa.LAUNCHES.name]
            step_logits = [lg]
            _reset_counts()
            for t in range(LM_NEW - 1):
                lg, state = eng.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], state,
                                       LM_PROMPT + t)
                step_logits.append(lg)
            torch.cuda.synchronize()
            decode_launches = _counts()[fa.LAUNCHES.name]
        served = torch.cat(step_logits, dim=1).float()  # (B, 32, V): positions 1023 .. 1054
        diff = torch.abs(served - teacher)
        found[name] = {
            "prefill_launches": prefill_launches, "decode_launches": decode_launches,
            "finite": bool(torch.isfinite(served).all()) and bool(torch.isfinite(teacher).all()),
            "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
            "scale": torch.abs(teacher).max().item(),
            "token_agreement": float((served.argmax(-1) == teacher.argmax(-1)).float().mean()),
            "dropped": {k: int(sum(d.item() for d in v)) for k, v in drops.items()},
            "pinned_calls": len(flips),
            "routing_flips": {"prefill": int(sum(f.item() for f in flips[:cfg.n_layers])),
                              "decode": int(sum(f.item() for f in flips[cfg.n_layers:]))}}
        del state, step_logits, served, teacher, diff, routes
    del dropless
    prof_state = engine.init_state(LM_BATCH)
    prof_prefill = _profile(lambda: engine.prefill({"tokens": toks_d[:, :LM_PROMPT]}, prof_state))

    def four_steps():
        for t in range(4):
            engine.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], prof_state, LM_PROMPT + t)

    prof_decode = _profile(four_steps)
    _emit({"profile": "moe prefill (4 x 1,024 tokens)", **prof_prefill})
    _emit({"profile": "moe decode (4 steps)", **prof_decode})
    del prof_state
    served, free = found["served"], found["dropless pinned"]
    prefill_launches, decode_launches = served["prefill_launches"], served["decode_launches"]
    scale, teacher_err = free["scale"], free["max_abs_diff"]
    finite = served["finite"] and free["finite"]
    new_tok = LM_BATCH * LM_NEW
    assignments = LM_BATCH * cfg.experts_per_token * cfg.n_layers
    row = {"row": "moe serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "experts": [cfg.n_experts, cfg.experts_per_token, cfg.d_ff_expert],
           "vocab": cfg.vocab_size, "params": common.count_params(engine.params),
           "active_params": cfg.active_params(), "dtype": "bfloat16", "cache_dtype": "float32",
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "capacity": [moe.capacity(LM_PROMPT, cfg), moe.capacity(1, cfg)],
           "init_s": init_s, "first_generate_s": first_s,
           "flash_launches": launches, "expected_launches": cfg.n_layers,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4,
           "prefill_ms": tm["prefill_s"] * 1e3,
           "decode_ms_per_token": tm["decode_s"] * 1e3 / tm["decode_steps"],
           "generate_wall_ms": wall_s * 1e3, "new_tokens_per_s": new_tok / wall_s,
           "decode_tokens_per_s": LM_BATCH * tm["decode_steps"] / tm["decode_s"],
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / tm["prefill_s"],
           "peak_memory_GB": peak_gb, "same_tokens_twice": bool(np.array_equal(tokens, again)),
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "assignments": {"prefill": assignments * LM_PROMPT,
                           "teacher": assignments * (LM_PROMPT + LM_NEW - 1)},
           "dropped_assignments": served["dropped"],
           "dropless_dropped_assignments": free["dropped"],
           "pinned_calls": free["pinned_calls"], "routing_flips_pinned": free["routing_flips"],
           "logits_finite": finite,
           "teacher_max_abs_diff": teacher_err, "teacher_mean_abs_diff": free["mean_abs_diff"],
           "teacher_logit_scale": scale, "teacher_tol": LM_TEACHER_TOL * scale,
           "teacher_token_agreement": free["token_agreement"],
           "served_config_teacher": {k: served[k] for k in (
               "max_abs_diff", "mean_abs_diff", "scale", "token_agreement")},
           "pinned_launches": [free["prefill_launches"], free["decode_launches"]]}
    row["ok"] = (launches == cfg.n_layers and prefill_launches == cfg.n_layers
                 and decode_launches == 0 and row["other_launches"] == 0 and finite
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
                 and free["dropped"] == {"prefill": 0, "teacher": 0}
                 and free["pinned_calls"] == cfg.n_layers * LM_NEW
                 and teacher_err <= LM_TEACHER_TOL * scale)
    _emit(row)
    if not row["ok"]:
        failures.append(f"moe serve main path: {row}")
    del engine, model, toks_d
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, 2 layers, f32 ----------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _serve_cross_device("moe cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), 0.02, seed), rng,
        failures)
    return launches


def _snapshot(params, opt_state) -> list:
    """Copies of every parameter, moment and the step count, on the card."""
    return ([p.detach().clone() for p in params.parameters()]
            + [t.clone() for k in ("m", "v") for t in opt_state[k].values()]
            + [opt_state["count"].clone()])


def _live(params, opt_state) -> list:
    return ([p.detach() for p in params.parameters()]
            + [t for k in ("m", "v") for t in opt_state[k].values()] + [opt_state["count"]])


def _moe_train(seed: int, failures: list[str]) -> tuple[int, int]:
    """``train.loop.train`` on full-width, full-depth granite-moe (f32
    master weights and moments, bf16 compute, remat) for TRAIN_STEPS steps,
    the counters set to 0 just before and read just after (48 flash forward
    launches a step, half of them the remat recompute; 24 backward calls);
    one more step twice from one state, bitwise; a profiled step and the
    gradient / optimizer split; one step's loss and gradients, the card
    against the CPU at 2 layers in f32 (matrices at std 0.02), routing
    equal; 4 steps straight
    against 2 + checkpoint + restore + 2, bitwise.  Returns the flash
    forward and backward launches of the training run."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, moe, registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop, train_step

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            log_every=1, seed=seed, opt=opt)
    log_lines: list[str] = []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = loop.train(cfg, tcfg, log=log_lines.append, device=dev)
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = counts[fa.LAUNCHES.name], counts[fa.BWD_LAUNCHES.name]
    for line in log_lines:
        print(f"moe train: {line}")
    hist, step_ms = out["history"], out["step_ms"]
    for h, ms in zip(hist, step_ms):
        _emit({"moe_train_step": h["step"], "loss": h["loss"], "nll": h["nll"], "aux": h["aux"],
               "grad_norm": h["grad_norm"], "lr": h["lr"], "step_ms": ms})
    params, opt_state = out["params"], out["opt_state"]
    del out
    n_params = common.count_params(params)

    # one more step twice from the same state: the same bits
    step_fn = train_step.make_train_step(cfg, opt, q_chunk=512, kv_chunk=1024)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed))
    batch, _ = make_train_batch(pipe, PipelineState(step=TRAIN_STEPS), cfg, device=dev)
    start = _snapshot(params, opt_state)
    _, _, m1 = step_fn(params, opt_state, batch)
    first = _snapshot(params, opt_state)
    with torch.no_grad():
        for t, s in zip(_live(params, opt_state), start):
            t.copy_(s)
    _, _, m2 = step_fn(params, opt_state, batch)
    twice = (all(torch.equal(a, b) for a, b in zip(first, _live(params, opt_state)))
             and all(torch.equal(m1[k], m2[k]) for k in m1))
    _emit({"row": "moe train same bits twice", "arch": cfg.name, "tensors": len(first),
           "loss": m1["loss"].item(), "bitwise": twice})
    if not twice:
        failures.append("moe train: one step twice from one state differs")
    del start, first
    torch.cuda.empty_cache()
    # where the time goes: one more step under the profiler, then the split
    prof = _profile(lambda: step_fn(params, opt_state, batch), top=10)
    _emit({"profile": f"moe train step ({TRAIN_BATCH} x {TRAIN_SEQ} tokens)", **prof})
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=512, kv_chunk=1024)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    grads, _ = grad_fn(params, batch)
    marks[1].record()
    adamw.update(grads, opt_state, params, opt)
    marks[2].record()
    torch.cuda.synchronize()
    grad_ms, opt_ms = marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
    del params, opt_state, batch, step_fn, grads, grad_fn
    torch.cuda.empty_cache()

    losses, gnorms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    nlls, auxs = [h["nll"] for h in hist], [h["aux"] for h in hist]
    start_nll = math.log(cfg.vocab_size)
    median_ms = float(np.median(step_ms[1:]))
    steps = len(hist)
    row = {"row": "moe train", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params, "master_dtype": "float32",
           "moment_dtype": opt.moment_dtype, "compute_dtype": cfg.dtype, "remat": True,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "capacity": moe.capacity(TRAIN_SEQ, cfg),
           "steps": steps, "losses": losses, "nlls": nlls, "auxs": auxs, "grad_norms": gnorms,
           "step_ms": step_ms, "step_ms_median_2_5": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
           "split_grad_ms": grad_ms, "split_optimizer_ms": opt_ms,
           "peak_memory_GB": peak_gb, "wall_s": wall_s,
           "flash_launches": fwd, "flash_bwd_launches": bwd,
           "flash_launches_per_step": fwd / steps, "flash_bwd_launches_per_step": bwd / steps,
           "expected_per_step": [2 * cfg.n_layers, cfg.n_layers],
           "other_launches": sum(counts.values()) - fwd - bwd,
           "profiled_kernel_launches": prof["kernel_launches"],
           "profiled_launches_by_class": prof["launches_by_class"],
           "idle_share": prof["idle_share"], "start_nll_target": start_nll,
           "start_nll_tol": TRAIN_START_TOL}
    row["ok"] = (steps == TRAIN_STEPS and all(math.isfinite(x) for x in losses + gnorms + auxs)
                 and abs(nlls[0] - start_nll) <= TRAIN_START_TOL
                 and fwd == 2 * cfg.n_layers * steps and bwd == cfg.n_layers * steps
                 and row["other_launches"] == 0)
    _emit(row)
    if not row["ok"]:
        failures.append(f"moe train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, 2 layers, f32 -------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _train_cross_device("moe train cross-device", cfg2, common.trainable(_matrices_at(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), 0.02, seed)), seed,
        failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("moe train resume", cfg2, seed, failures)
    return fwd, bwd


def _moe_yardsticks(rng, hw, failures: list[str]) -> None:
    """The flash forward and backward at granite-moe's shapes (bf16, causal,
    16/8 heads of 64): each against its plain version within
    ``kernel_tolerance`` (the backward against each gradient's max, and
    twice bitwise), then timed (eager calls; the kernels also in a CUDA
    graph, where the wrapper's host cost does not show: at D=64 it is a
    large part of an eager call) beside the plain version, SDPA (its
    backward) and the bound."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = get_config(MOE_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    atol, rtol = fa.kernel_tolerance(bf16)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, bf16)

    # the forward at the prefill shape
    b, s = LM_BATCH, LM_PROMPT
    q, k, v = normal(b, s, hq, d), normal(b, s, hkv, d), normal(b, s, hkv, d)
    got, want = fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    kernel_ms = _time_ms(lambda: fa.flash_attention(q, k, v), reps=20)
    kernel_graph_ms = _graph_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    library_ms = _time_ms(sdpa, reps=20)
    library_graph_ms = _graph_ms(sdpa)
    bound = roofline.attention_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d, dtype=bf16,
                                     hw=hw) if hw is not None else None
    executed = fa.executed_flops(b, s, s, hq, hkv, d)
    _emit({"yardstick": f"flash_attention bf16 causal B={b} S={s} Hq={hq} Hkv={hkv} D={d}",
           "max_abs_err": diff.max().item(), "atol": atol, "rtol": rtol, "ok": ok,
           "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_graph_ms": library_graph_ms,
           "library_call": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
           "flops": None if bound is None else bound.flops,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "kernel_vs_library": kernel_ms / library_ms, "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9})
    if not ok:
        failures.append(f"flash_attention vs plain at D={d} G={hq // hkv}: {diff.max().item()}")
    del q, k, v, got, want, diff, qt, kt, vt

    # the backward at the training shape
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, dout = normal(b, s, hq, d), normal(b, s, hkv, d), normal(b, s, hkv, d), \
        normal(b, s, hq, d)
    o, lse = fa._forward(q, k, v, causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                         with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, dout, lse)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse)
    want = fa.flash_attention_bwd_plain(q, k, v, o, dout, lse, causal=True, q_chunk=512,
                                        kv_chunk=1024)
    shares = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        shares[name] = err / (atol + rtol * scale)
    ok = (max(shares.values()) <= 1.0 and all(torch.equal(x, y) for x, y in zip(got, again))
          and all(bool(torch.isfinite(g.float()).all()) for g in got))
    kernel_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse), reps=50)
    kernel_graph_ms = _graph_ms(lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse))
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, dout, lse), reps=3,
                        warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dout.transpose(1, 2),  # noqa: E731
                                           retain_graph=True)
    library_ms = _time_ms(sdpa_bwd, reps=50)
    bound = roofline.attention_bwd_bound(batch=b, sq=s, skv=s, hq=hq, hkv=hkv, d=d, dtype=bf16,
                                         hw=hw) if hw is not None else None
    executed = fa.bwd_executed_flops(b, s, s, hq, hkv, d)
    _emit({"yardstick": f"flash_attention_bwd bf16 causal B={b} S={s} Hq={hq} Hkv={hkv} D={d}",
           "share_of_limit": shares, "bitwise_twice": all(
               torch.equal(x, y) for x, y in zip(got, again)), "ok": ok,
           "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "timing": "*_ms: eager calls; kernel_graph_ms: CUDA graph of 20 calls",
           "library_call": "backward of F.scaled_dot_product_attention(is_causal=True, "
                           "enable_gqa=True) (torch.autograd.grad)",
           "flops": None if bound is None else bound.flops,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "kernel_vs_library": kernel_ms / library_ms, "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9})
    if not ok:
        failures.append(f"flash_attention_bwd vs plain at D={d} G={hq // hkv}: {shares}")


MULTISLAB_FORMS = [  # (label, hosts, layout, dtype, accum, compression)
    ("soa f32", 2, "soa", "float32", "", "none"),
    ("aosoa f32", 2, "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", 2, "soa", "bfloat16", "float32", "none"),
    ("soa f32 two-row", 2, "soa", "float32", "", "two_row"),
    ("soa f32", 4, "soa", "float32", "", "none"),
    ("aosoa bf16 two-row", 4, "aosoa", "bfloat16", "", "two_row"),
]
MULTISLAB_TRACED_STEPS = 5  # traced steps per depth for the phase split
TUNE_TILES = (256, 512)  # the tuners' pruned tile grid


@contextlib.contextmanager
def _recording(name: str, sink: list, u_phys, keep: int = 4):
    """Record (cloned) the inputs of up to ``keep`` launches of stencil
    kernel ``name`` on links other than ``u_phys`` (the boundary and ring
    passes of the multi-slab schedules); every launch still runs."""
    from repro_torch.kernels import su3_stencil

    orig = getattr(su3_stencil, name)

    def rec(*args, **kw):
        if args[0].data_ptr() != u_phys.data_ptr() and len(sink) < keep:
            sink.append(([a.clone() for a in args], dict(kw)))
        return orig(*args, **kw)

    setattr(su3_stencil, name, rec)
    try:
        yield sink
    finally:
        setattr(su3_stencil, name, orig)


def _counted(fn, totals: dict[str, int]):
    """Run ``fn`` with every launch counter set to 0 just before and read
    just after; add the counts to ``totals``.  Returns (result, counts)."""
    import torch

    torch.cuda.synchronize()
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _counts()
    for k in totals:
        totals[k] += counts[k]
    return out, counts


def _recorded_vs_plain(name: str, records: list, dtype: str, accum: str, comp: str) -> dict:
    """Each recorded launch's inputs through the kernel and its plain
    version: bitwise at f32, within ``verify_tolerance`` otherwise."""
    import torch

    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import su3_stencil

    kernel = getattr(su3_stencil, name)
    plain = getattr(su3_stencil, f"{name}_plain")
    err, bitwise, shapes = 0.0, True, []
    for args, kw in records:
        got = kernel(*args, **kw)
        want = plain(*args, accum_dtype=kw.get("accum_dtype"),
                     compressed=kw.get("compressed", False))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        shapes.append(list(args[0].shape))
        err = max(err, max(torch.max(torch.abs(g.float() - w.float())).item()
                           for g, w in zip(got, want)))
        bitwise &= all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    tol = verify_tolerance(dtype, accum, comp == "two_row")
    ok = bool(records) and (bitwise if dtype == "float32" else err <= tol)
    return {"kernel": name, "launches_checked": len(records), "link_shapes": shapes,
            "max_abs_err": err, "bitwise": bitwise, "ok": ok}


def _host_wall_ms(fn, reps: int) -> float:
    """Best host-clock ms of ``fn`` followed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _multislab_phase(u, seed: int, hw, failures: list[str]) -> dict[str, int]:
    """The lattice split into 2 and 4 t-slabs of PAPER_L32 on the card:
    first-touch init and the multiply against one slab; the overlapped
    stencil (depth 1 and 2) and the overlapped fused CG against the serial
    and one-slab paths, bitwise, with their boundary and ring launches held
    against the plain versions; the halo faults; the times and the phase
    split; the stencil and CG tuners at 2 slabs; attribution; provenance.
    Returns the counted main-path launches per kernel."""
    import numpy as np
    import torch

    from repro_torch.chaos import NULL_FAULT_PLAN, FaultPlan, FaultSpec
    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import autotune
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import build_plan
    from repro_torch.kernels import su3_matmul, su3_stencil
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.obs import (NULL_TRACER, Tracer, attribution_report, overlap_efficiency,
                                 overlap_efficiency_from_spans, provenance_block,
                                 render_attribution)

    mult, sten, cgk = (su3_matmul.LAUNCHES.name, su3_stencil.STENCIL_LAUNCHES.name,
                       su3_stencil.CG_LAUNCHES.name)
    totals = {mult: 0, sten: 0, cgk: 0}

    def fail(what: str, row: dict) -> None:
        _emit(row)
        if not row["ok"]:
            failures.append(f"multislab {what}: {row}")

    # -- init and the multiply ----------------------------------------------------
    one = build_plan(PAPER_L32)
    a1, b1, init1, _ = one.init_data()
    c1 = one.step(a1, b1)
    for hosts in (2, 4):
        many = build_plan(PAPER_L32, MeshSpec(hosts=hosts))
        a2, b2, init2, _ = many.init_data()
        c2, counts = _counted(lambda: many.step(a2, b2), totals)
        row = {"row": "multislab init + step", "hosts": hosts, "plan": many.describe(),
               "first_touch_equals_one_slab": torch.equal(_bits(a2), _bits(a1)),
               "step_equals_one_slab": torch.equal(_bits(c2), _bits(c1)),
               "verified": many.verify(c2), "init_s": init2, "one_slab_init_s": init1,
               "launches": counts[mult], "expected_launches": 1}
        row["ok"] = (row["first_touch_equals_one_slab"] and row["step_equals_one_slab"]
                     and row["verified"] and counts[mult] == 1)
        fail("init", row)
        del many, a2, c2
    del one, a1, c1

    # -- the stencil schedules ------------------------------------------------------
    rng = np.random.default_rng(seed + 16)
    n_sites = PAPER_L32.shape.n_sites
    v_c = torch.from_numpy((rng.standard_normal((n_sites, 3))
                            + 1j * rng.standard_normal((n_sites, 3))).astype(np.complex64)).cuda()
    timing_plans = {}
    for label, hosts, layout, dtype, accum, comp in MULTISLAB_FORMS:
        cfg = dataclasses.replace(PAPER_L32, layout=Layout(layout), dtype=dtype,
                                  accum_dtype=accum, compression=comp)
        one, many = build_plan(cfg), build_plan(cfg, MeshSpec(hosts=hosts))
        u_phys, v_p = many.pack_gauge(u), many.pack_rhs(v_c)
        step, step2 = many.stencil_step(), many.stencil_step(depth=2)
        with _recording("su3_stencil_planar", [], u_phys) as records:
            (o1, o2), counts = _counted(lambda: (step(u_phys, v_p), step2(u_phys, v_p)), totals)
        s1 = one.stencil_step()(u_phys, v_p)
        s2 = one.stencil_step()(u_phys, s1)
        serial = many.stencil_step(overlap=False)(u_phys, v_p)
        row = {"row": "multislab stencil_step", "form": label, "hosts": hosts,
               "plan": many.describe(), "boundary_sites": many.stencil_halo().boundary_sites * hosts,
               "overlap_equals_serial": torch.equal(_bits(o1), _bits(serial)),
               "overlap_equals_one_slab": torch.equal(_bits(o1), _bits(s1)),
               "depth2_equals_two_steps": torch.equal(_bits(o2), _bits(s2)),
               "launches": counts[sten], "expected_launches": 2 + 5,
               "kernels_on_new_shapes": _recorded_vs_plain("su3_stencil_planar", records,
                                                           dtype, accum, comp)}
        row["ok"] = (row["overlap_equals_serial"] and row["overlap_equals_one_slab"]
                     and row["depth2_equals_two_steps"] and counts[sten] == 7
                     and counts[cgk] == 0 and row["kernels_on_new_shapes"]["ok"]
                     and len(records) == 4)
        fail("stencil", row)
        if label == "soa f32":
            timing_plans[hosts] = (one, many, u_phys, v_p)
        del records, o1, o2, s1, s2, serial

    # -- times, the phase split, overlap efficiency, the ghost copy -------------------
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    tracer = Tracer()  # one tracer, so that span ids stay unique across the runs
    for hosts, (one, many, u_phys, v_p) in timing_plans.items():
        step, step2 = many.stencil_step(), many.stencil_step(depth=2)
        serial_one = one.stencil_step()
        parts = many._stencil_overlap_parts()
        halo = many.stencil_halo()
        ghost_bytes = autotune._exchange_bytes(halo, hosts, 1, 1)
        ghost_ms = _time_ms(lambda: parts["exchange"](v_p), reps=50)
        times = {
            "serial_ms": _best_ms(lambda: serial_one(u_phys, v_p), STENCIL_REPS),
            "overlapped_ms": _best_ms(lambda: step(u_phys, v_p), STENCIL_REPS),
            "depth2_ms_per_application": _best_ms(lambda: step2(u_phys, v_p), STENCIL_REPS) / 2,
            "serial_wall_ms": _host_wall_ms(lambda: serial_one(u_phys, v_p), STENCIL_REPS),
            "overlapped_wall_ms": _host_wall_ms(lambda: step(u_phys, v_p), STENCIL_REPS),
            "depth2_wall_ms_per_application":
                _host_wall_ms(lambda: step2(u_phys, v_p), STENCIL_REPS) / 2,
        }
        split = {}
        for depth, fn in ((1, step), (2, step2)):
            many.tracer = tracer
            for _ in range(MULTISLAB_TRACED_STEPS):
                fn(u_phys, v_p)
            many.tracer = NULL_TRACER
            spans = tracer.spans()
            steps = {x.span_id for x in spans if x.name == "stencil.step"
                     and (x.attrs["hosts"], x.attrs["depth"]) == (hosts, depth)}
            acct = overlap_efficiency_from_spans(
                [x for x in spans if x.span_id in steps or x.parent_id in steps])
            wall_s = times["overlapped_wall_ms" if depth == 1 else
                           "depth2_wall_ms_per_application"] * depth / 1e3
            split[f"depth{depth}"] = {
                "phase_ms": {k: v * 1e3 for k, v in acct["phase_s"].items()},
                "sum_phases_ms": acct["sum_phases_s"] * 1e3,
                "traced_wall_ms": acct["traced_wall_s"] * 1e3,
                "overlap_efficiency": overlap_efficiency(acct["sum_phases_s"], wall_s)}
        _emit({"row": "multislab times", "hosts": hosts, "card": card, "form": "soa f32 L=32",
               **times, "ghost_copy_ms": ghost_ms, "ghost_copy_bytes": ghost_bytes,
               "ghost_copy_bytes_ms": None if hw is None else ghost_bytes / hw.hbm_bw * 1e3,
               "exchange_latency_s": None if hw is None else
               ghost_ms / 1e3 - ghost_bytes / hw.hbm_bw,
               "boundary_sites": halo.boundary_sites * hosts, **split,
               "timing": "*_ms: CUDA events on the main stream, best of "
                         f"{STENCIL_REPS}; *_wall_ms: host clock to a synchronize"})
    del timing_plans

    # -- attribution of the traced steps ------------------------------------------------
    if hw is not None:
        rows = attribution_report(tracer.spans(), hw=hw)
        for r in rows:
            _emit({"attribution": r})
        print(render_attribution(rows))

    # -- the fused CG, overlapped ---------------------------------------------------------
    u_np, b_np = _cg_measure_problem(PAPER_L32.L)
    one = build_plan(PAPER_L32)
    u1, b1 = one.pack_gauge(u_np), one.pack_rhs(b_np)
    ref = one.cg_solve(u1, b1)
    for hosts in (2, 4):
        many = build_plan(PAPER_L32, MeshSpec(hosts=hosts))
        with _recording("su3_cg_fused_planar", [], u1, keep=2) as records:
            res, counts = _counted(lambda: many.cg_solve(u1, b1, fused=True, overlap=True),
                                   totals)
        comp = many.cg_solve(u1, b1, fused=False, overlap=True)
        dispatched = res.iterations + 1
        timed = {}
        for name, plan in (("one_slab", one), ("overlapped", many)):
            state = plan.cg_state_init(b1)
            for _ in range(2):
                state = plan.cg_iterate(u1, state)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CG_TIMED_ITERS):
                state = plan.cg_iterate(u1, state)
            end.record()
            torch.cuda.synchronize()
            timed[f"{name}_iteration_ms"] = start.elapsed_time(end) / CG_TIMED_ITERS
        row = {"row": "multislab cg_solve fused overlapped", "hosts": hosts,
               "iterations": res.iterations, "one_slab_iterations": ref.iterations,
               "converged": res.converged,
               "residuals_equal_one_slab": res.residuals == ref.residuals,
               "x_equals_one_slab_bitwise": torch.equal(_bits(res.x_p), _bits(ref.x_p)),
               "composed_equals_fused_bitwise": comp.residuals == res.residuals
               and torch.equal(_bits(comp.x_p), _bits(res.x_p)),
               "launches": counts[cgk], "expected_launches": 2 * dispatched, **timed,
               "kernels_on_new_shapes": _recorded_vs_plain("su3_cg_fused_planar", records,
                                                           "float32", "", "none")}
        row["ok"] = (res.converged and res.iterations == ref.iterations
                     and row["residuals_equal_one_slab"] and row["x_equals_one_slab_bitwise"]
                     and row["composed_equals_fused_bitwise"]
                     and counts[cgk] == 2 * dispatched and counts[sten] == 0
                     and row["kernels_on_new_shapes"]["ok"])
        fail("cg", row)
        del many, records, res, comp
    del one, u1, b1

    # -- the halo seam --------------------------------------------------------------------
    many = build_plan(PAPER_L32, MeshSpec(hosts=2))
    u_phys, v_p = many.pack_gauge(u), many.pack_rhs(v_c)
    step = many.stencil_step()
    clean = step(u_phys, v_p).clone()
    many.faults = FaultPlan(seed, {"halo": FaultSpec(probability=1.0, actions=("drop",))})
    dropped = step(u_phys, v_p)
    fired = many.faults.fired
    drop_changes = not torch.equal(dropped, clean)
    many.faults = FaultPlan(seed, {"halo": FaultSpec(probability=1.0, actions=("corrupt",))})
    poisoned = not bool(torch.isfinite(step(u_phys, v_p)).all())
    many.faults = NULL_FAULT_PLAN
    restored = torch.equal(_bits(step(u_phys, v_p)), _bits(clean))
    row = {"row": "multislab halo faults", "hosts": 2, "drop_fired": fired,
           "drop_changes_result": drop_changes, "corrupt_non_finite": poisoned,
           "null_plan_bitwise_clean": restored}
    row["ok"] = fired == 1 and drop_changes and poisoned and restored
    fail("halo", row)
    del many, u_phys, v_p, clean, dropped, v_c
    torch.cuda.empty_cache()

    # -- the tuners at 2 slabs, on a pruned grid ----------------------------------------------
    cache = str(ROOT / "build" / "chip_smoke_autotune")
    t0 = time.perf_counter()
    st = autotune.best_stencil_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES, refresh=True,
                                      cache_directory=cache, hw=hw)
    cg = autotune.best_cg_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES, refresh=True,
                                 cache_directory=cache, hw=hw)
    again = autotune.best_stencil_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES,
                                         cache_directory=cache, hw=hw)
    row = {"row": "multislab tuners", "hosts": 2, "stencil": st, "cg": cg,
           "stencil_cached_again": again["cached"], "seconds": time.perf_counter() - t0}
    row["ok"] = again["cached"] and again["tile"] == st["tile"] and not st["cached"]
    fail("tuners", row)

    _emit({"provenance": provenance_block(str(ROOT))})
    return totals


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
