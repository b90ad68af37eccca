"""Batched SU3 lattice serving on the port, through the ``SU3Service``
front door.

Each request carries its own (A, B) lattice pair.  Requests flow through the
dynamic batcher ((L, k) buckets, warm-size padding, admission control) into
a warm pool of ``BatchedLatticeRunner`` plans that run the CUDA multiply on
the card (its plain version on the CPU); ``--bf16`` serves bf16-storage /
f32-accumulate plans, which stream half the HBM bytes.  With
``--autotune`` the plan's tile and the default chain depth come from the
port's autotune cache (``--cache-dir``, else ``$REPRO_TORCH_SU3_CACHE_DIR``,
else ``build/repro_torch/autotune``): the first run on a device measures,
every later one starts tuned.

    PYTHONPATH=src python examples/torch/serve_lattices.py --batch 8 --L 4 --chain 3
    PYTHONPATH=src python examples/torch/serve_lattices.py --batch 8 --bf16
    PYTHONPATH=src python examples/torch/serve_lattices.py --batch 5 --L 2 --autotune --device cpu
"""
import argparse
import time

import torch

from repro_torch.core.su3.plan import cli_device
from repro_torch.serve.su3 import BatcherConfig, ServiceConfig, SU3Service, request_flops


def _random_requests(batch: int, n_sites: int, seed: int = 0):
    """``batch`` canonical complex lattices (n_sites, 4, 3, 3) and link
    sets (4, 3, 3), drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))

    return draw(batch, n_sites, 4, 3, 3), draw(batch, 4, 3, 3)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8, help="independent user lattices")
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--chain", type=int, default=0,
                    help="multiplies chained per request "
                         "(0 = the autotuned fused depth from the cache)")
    ap.add_argument("--tile", type=int, default=0,
                    help="explicit tile; overrides --autotune")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16-storage / f32-accumulate serving plans")
    ap.add_argument("--autotune", action="store_true",
                    help="build the pool through the persistent autotune cache "
                         "(first run measures once, later runs start tuned)")
    ap.add_argument("--cache-dir", default=None, help="the autotune cache directory")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = cli_device(args.device)
    width = max(8, args.batch)
    svc = SU3Service(ServiceConfig(
        dtype="bfloat16" if args.bf16 else "float32",
        accum_dtype="float32" if args.bf16 else "",
        autotune=args.autotune and not args.tile,
        tile=args.tile,
        cache_directory=args.cache_dir,
        batcher=BatcherConfig(max_batch=width, warm_batch_sizes=(1, 2, 4, 8, width),
                              max_queue_depth=4 * width),
    ), device=dev)

    n_sites = args.L**4
    a, b = _random_requests(args.batch, n_sites)
    a, b = a.to(dev), b.to(dev)
    k = args.chain or None  # None: the service's default (autotuned with --autotune)

    # warm pass: the plan builds outside the timed window, as at rollout
    ids = [svc.submit(a[i], b[i], k=k) for i in range(args.batch)]
    svc.run_until_drained()
    resolved_k = args.chain or svc.default_k_for(args.L)
    for rid in ids:
        svc.pop_result(rid)
    svc.metrics.reset()

    t0 = time.perf_counter()
    ids = [svc.submit(a[i], b[i], k=k) for i in range(args.batch)]
    served = svc.run_until_drained()
    c = [svc.pop_result(rid) for rid in ids]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    ecfg = svc.runner_for(args.L).cfg
    print(f"plan: layout={ecfg.layout.value} variant={ecfg.variant} "
          f"tile={ecfg.tile} dtype={ecfg.dtype}"
          + (f" accum={ecfg.accum_dtype}" if ecfg.is_mixed_precision else "")
          + f" chain_k={resolved_k}")
    flops = args.batch * request_flops(n_sites, resolved_k)
    print(f"served {served} lattices (L={args.L}, {n_sites} sites, chain={resolved_k}) "
          f"on {dev} in {wall * 1e3:.1f} ms -> {flops / wall / 1e9:.2f} GF/s aggregate")
    snap = svc.metrics.snapshot()
    print(f"metrics: p50={snap['latency_p50_ms']} ms p99={snap['latency_p99_ms']} ms "
          f"occupancy={snap['mean_batch_occupancy']} live/batch={snap['mean_live_batch']} "
          f"dispatches={snap['dispatches']}")
    print("sample C[0,0,0]:", c[0][0, 0, 0].cpu())
    return 0 if served == args.batch else 1


if __name__ == "__main__":
    raise SystemExit(main())
