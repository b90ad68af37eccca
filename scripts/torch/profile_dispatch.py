#!/usr/bin/env python
"""Dispatch profiler on the port: the per-launch overhead of the SU3
multiply and what the serving megakernel saves of it.

The paper's PIUMA conclusion (§5.3) is that SU3_Bench's ceiling is how
fast work can be issued.  On the serving stack the analogous tax is the
launch: every one pays a fixed host-side cost (the ctypes wrapper's and the
driver's), which dominates at small lattices.  Two tables:

  dispatch_overhead_L{L}
      K single-step launches against ONE fused(K) launch of the same K
      multiplies (``SU3Engine.compare_fused``); the difference over K - 1
      is the cost of one launch.
  megakernel_amortization_L{L}
      a SLOTS-slot table advanced one iteration as SLOTS single-lattice
      launches (the per-chain path) against ONE megakernel launch
      (``ExecutionPlan.fused_batched_step``) on the same slot data.

The megakernel rows are timed through the port's ``obs.Tracer``: every rep
is a ``profile.dispatch`` span on the host clock around work that ends in
a device synchronize, and the rows are medians of those spans.  ``--trace
PATH`` exports them (``.jsonl`` flat, else Chrome trace-event JSON with the
run's provenance) for ``scripts/torch/trace_report.py``.  ``--json PATH``
writes the rows to a file of their own; the reference's artifact
``BENCH_su3.json`` is never written.

    PYTHONPATH=src python scripts/torch/profile_dispatch.py --quick            # the card
    PYTHONPATH=src python scripts/torch/profile_dispatch.py --quick --device cpu \\
        --json build/dispatch.json --trace build/dispatch.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from repro_torch.core.su3.engine import EngineConfig, SU3Engine
from repro_torch.core.su3.layouts import Layout
from repro_torch.core.su3.plan import cli_device
from repro_torch.obs import Tracer, provenance_block

SLOTS = 4
FUSED_K = 4
TILE = 128
REFERENCE_ARTIFACT = "BENCH_su3.json"


def _config(L: int) -> EngineConfig:
    return EngineConfig(L=L, dtype="float32", variant="cuda", layout=Layout.SOA, tile=TILE,
                        iterations=1, warmups=1)


def _median_wall(tracer: Tracer, fn, reps: int, label: str, **attrs) -> float:
    spans = []
    for _ in range(reps):
        with tracer.span("profile.dispatch", label=label, **attrs) as sp:
            fn()
        spans.append(sp)
    return float(statistics.median(s.dur_s for s in spans))


def dispatch_overhead_row(L: int, device: torch.device, k: int = FUSED_K,
                          reps: int = 5) -> dict:
    """K launched single steps against one fused(K) launch (the engine's
    protocol, between CUDA events on the card)."""
    cmp = SU3Engine(_config(L), device).compare_fused(k=k, reps=reps)
    per_dispatch_s = max(cmp["dispatched_s"] - cmp["fused_s"], 0.0) / (k - 1)
    return {
        "name": f"dispatch_overhead_L{L}", "L": L, "k": k, "device": str(device),
        "dispatches_chained": k, "dispatches_fused": 1,
        "chained_s": cmp["dispatched_s"], "fused_s": cmp["fused_s"],
        "per_dispatch_overhead_us": per_dispatch_s * 1e6,
        "fused_speedup": cmp["fused_speedup"],
        "GFLOPS": cmp["result"].row()["GFLOPS"],  # fused, per multiply
        "verified": cmp["result"].verified,
    }


def megakernel_amortization_row(L: int, device: torch.device, tracer: Tracer,
                                slots: int = SLOTS, reps: int = 5) -> dict:
    """SLOTS single-lattice launches against ONE megakernel launch per
    iteration on the same slot data (out of place, so every rep multiplies
    the same table)."""
    plan = SU3Engine(_config(L), device).plan
    gen = torch.Generator().manual_seed(0)
    shape = (slots, plan.padded_sites, 4, 3, 3)
    a = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
    b = torch.complex(torch.randn((slots, 4, 3, 3), generator=gen),
                      torch.randn((slots, 4, 3, 3), generator=gen))
    a_phys = torch.stack([plan.codec.pack(x) for x in a]).contiguous().to(device)
    b_p = torch.stack([plan.codec.pack_b(x) for x in b]).contiguous().to(device)
    ones = torch.ones((slots,), dtype=torch.int32, device=device)
    mega = plan.fused_batched_step(slots, max_k=1, alias=False)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def per_chain() -> None:
        for s in range(slots):
            plan.step(a_phys[s], b_p[s])
        sync()

    def megakernel() -> None:
        mega(a_phys, b_p, ones)
        sync()

    per_chain()  # warm both paths before timing
    megakernel()
    chain_s = _median_wall(tracer, per_chain, reps, "per_chain", L=L, slots=slots)
    mega_s = _median_wall(tracer, megakernel, reps, "megakernel", L=L, slots=slots)
    return {
        "name": f"megakernel_amortization_L{L}", "L": L, "slots": slots, "device": str(device),
        "dispatches_per_iter_chains": slots, "dispatches_per_iter_megakernel": 1,
        "chains_s": chain_s, "megakernel_s": mega_s,
        "dispatch_amortization_speedup": chain_s / max(mega_s, 1e-9),
        "per_dispatch_overhead_us": max(chain_s - mega_s, 0.0) / (slots - 1) * 1e6,
        "GFLOPS": 864.0 * L**4 * slots / mega_s / 1e9,
    }


def run(device: torch.device, tracer: Tracer, quick: bool = True) -> list[dict]:
    rows = []
    for L in (2, 4) if quick else (4, 8):
        rows.append(dispatch_overhead_row(L, device))
        rows.append(megakernel_amortization_row(L, device, tracer))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="L = 2 and 4 (else 4 and 8)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--json", default="", help="write the rows to this file")
    ap.add_argument("--trace", default="",
                    help="export the spans (.jsonl flat, else Chrome trace-event JSON)")
    args = ap.parse_args(argv)
    if args.json and os.path.basename(args.json) == REFERENCE_ARTIFACT:
        ap.error(f"{REFERENCE_ARTIFACT} is the reference's artifact; write the port's rows "
                 f"to a file of their own")
    tracer = Tracer(enabled=True, capacity=4096)
    rows = run(cli_device(args.device), tracer, quick=args.quick)
    for r in rows:
        print(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": "su3-dispatch-rows/v1", "provenance": provenance_block(),
                       "dispatch": rows}, f, indent=2, default=str)
        print(f"# wrote the dispatch table to {args.json}", file=sys.stderr)
    if args.trace:
        if args.trace.endswith(".jsonl"):
            n = tracer.to_jsonl(args.trace)
        else:
            n = tracer.to_chrome_trace(args.trace, metadata=provenance_block())
        print(f"# wrote {n} spans to {args.trace}", file=sys.stderr)
    return 0 if all(r.get("verified", True) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
