"""Quickstart on the PyTorch/CUDA port: the SU3 multiply (the paper's
workload) against its oracle, the L=8 engine, and the roofline of the
paper's L=32 lattice on the H100.

    PYTHONPATH=src python examples/torch/quickstart.py                # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu   # plain versions

On the card ``ops.su3_mult`` runs the CUDA kernel; on the CPU its plain
PyTorch version.  Exits 1 if the multiply leaves the oracle or the engine
fails su3_bench's fixed point.
"""
import argparse

import torch

from repro_torch.configs.su3_bench import SMOKE_L8
from repro_torch.core import roofline
from repro_torch.core.su3.engine import SU3Engine
from repro_torch.core.su3.plan import cli_device
from repro_torch.kernels import ops, ref

ORACLE_TOL = 1e-4  # f32 products of O(1) entries, summed in another order


def _complex(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    return torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = cli_device(args.device)
    hw = roofline.current_hardware() if dev.type == "cuda" else roofline.H100_SXM
    if hw is None:
        raise LookupError(f"no Hopper spec for {torch.cuda.get_device_name(dev)}")
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")

    # 1. the multiply, canonical complex form, against the oracle
    gen = torch.Generator().manual_seed(0)
    a, b = _complex(gen, (1024, 4, 3, 3)).to(dev), _complex(gen, (4, 3, 3)).to(dev)
    err = (ops.su3_mult(a, b) - ref.su3_mult_ref(a, b)).abs().max().item()
    print(f"su3_mult vs oracle max err: {err:.2e}")

    # 2. the paper's benchmark loop (the L=8 smoke config)
    result = SU3Engine(SMOKE_L8, dev).run()
    print(f"engine: {result.row()}")

    # 3. the roofline of the paper's L=32, SoA f32, on the card's spec
    rep = roofline.analytic_su3_report(n_sites=32**4, bytes_per_site_rw=576, hw=hw)
    print(f"roofline L=32 on {hw.name}: {rep.bytes / 1e6:.1f} MB, {rep.flops / 1e9:.3f} GFLOP; "
          f"memory {rep.memory_s * 1e3:.4f} ms, compute {rep.compute_s * 1e3:.4f} ms: "
          f"bound by {rep.bound_by}, {rep.bound_s * 1e3:.4f} ms")
    print(f"{hw.name} bandwidth-bound GF/s (SoA): {hw.hbm_bw * (864 / 576) / 1e9:.0f}")
    return 0 if err <= ORACLE_TOL and result.verified else 1


if __name__ == "__main__":
    raise SystemExit(main())
