"""Serving launcher CLI (port of ``repro.launch.serve``), on the reduced
config of an architecture with random weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    device = resolve_device(args.device)
    api = registry.get(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed), cfg)
    engine = ServeEngine(
        cfg, params,
        ServeConfig(max_len=args.prompt_len + args.tokens + 8,
                    temperature=args.temperature, seed=args.seed),
        device=device,
    )
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
    )
    extras = {}
    if cfg.n_patches:
        extras["patches"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model),
            generator=torch.Generator(device=device).manual_seed(9), device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.tokens, extras=extras or None)
    dt = time.perf_counter() - t0
    print(f"{args.arch}: {out.shape[0]}x{args.tokens} tokens in {dt:.2f}s "
          f"({out.shape[0] * args.tokens / dt:.1f} tok/s on {device}, first call)")


if __name__ == "__main__":
    main()
