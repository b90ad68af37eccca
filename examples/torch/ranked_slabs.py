"""The SU3 plan's t-slabs on the ranks of a process group: each rank owns
``hosts / world`` contiguous slabs of the lattice and holds only their
sites; the +-t faces travel between ranks point to point.

    # two gloo ranks on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        examples/torch/ranked_slabs.py --device cpu --hosts 4 --L 8 --tile 64
    # one NCCL rank on the card (every face exchange then stays on the card)
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 1 \\
        examples/torch/ranked_slabs.py --hosts 2 --L 32

Every rank runs ``SU3Engine.run`` (su3_bench's fixed point), the stencil
overlapped and not at depth 1 and 2 on the stencil's fixed point, and CG
on the measurement problem; rank 0 prints the rows.  Exits 1 if a check
fails on any rank.
"""
import argparse
import json

import torch

from repro_torch.core.autotune import _cg_measure_problem
from repro_torch.core.su3.engine import SU3Engine
from repro_torch.core.su3.plan import EngineConfig, build_plan
from repro_torch.launch import mesh as meshes


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--hosts", type=int, default=2, help="t-slabs: a multiple of the world size")
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--tile", type=int, default=64)
    args = ap.parse_args(argv)
    dev = meshes.init_distributed(None if args.device == "cuda" else args.device)
    try:
        mesh = meshes.MeshSpec(hosts=args.hosts).resolve(dev)
        cfg = EngineConfig(L=args.L, tile=args.tile, iterations=3, warmups=1)
        row = SU3Engine(cfg, mesh).run().row()
        plan = build_plan(cfg, mesh)
        u, v = plan.init_stencil_data()
        outs = {(o, d): plan.stencil_step(overlap=o, depth=d)(u, v)
                for o in (True, False) for d in (1, 2)}
        same = all(torch.equal(outs[(True, d)], outs[(False, d)]) for d in (1, 2))
        stencil_ok = plan.every_rank(same) and plan.verify_stencil(outs[(True, 1)])
        u_cg, b_cg = _cg_measure_problem(args.L)
        res = plan.cg_solve(plan.pack_gauge(u_cg), plan.pack_rhs(b_cg))
        ok = row["verified"] and stencil_ok and res.converged
        if mesh.rank == 0:
            print(json.dumps({"engine": row, "stencil_ok": stencil_ok,
                              "cg_iterations": res.iterations, "cg_residual": res.residuals[-1],
                              "world": mesh.world, "slabs_per_rank": len(mesh.slabs),
                              "site_range": list(plan.site_range)}))
    finally:
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
