"""Batched serving on the port: prefill a prompt batch, decode N tokens,
on an architecture's reduced config with random weights.

    PYTHONPATH=src python examples/torch/serve_batched.py --arch yi-6b --tokens 16
    PYTHONPATH=src python examples/torch/serve_batched.py --arch internvl2-26b --device cpu

The VLM's patch embeddings and the encoder-decoder's frames are random
stand-ins for the stubbed front ends, drawn on the CPU from a seed and
moved, as extras of ``ServeEngine.generate``.  The default prompt length
holds the reduced VLM's 16 patch positions; a shorter prompt with patches
raises.  On the card an MLA config keeps deepseek-v3's head dims, the
flash kernel's MLA pair.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import cli_device
from repro_torch.models import mla, registry
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = cli_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.use_mla and dev.type == "cuda":
        cfg = mla.with_kernel_heads(cfg)
    params = registry.get(cfg).init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    engine = ServeEngine(cfg, params, ServeConfig(max_len=args.prompt_len + args.tokens + 8,
                                                  temperature=args.temperature, seed=args.seed),
                         device=dev)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    extras = {}
    if cfg.n_patches:
        extras["patches"] = torch.randn((args.batch, cfg.n_patches, cfg.d_model),
                                        generator=torch.Generator().manual_seed(9)).to(dev)
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.randn((args.batch, cfg.encoder_len, cfg.d_model),
                                       generator=torch.Generator().manual_seed(10)).to(dev)
    out = engine.generate(prompts, args.tokens, extras=extras or None)
    print(f"arch {args.arch} on {dev}: generated {out.shape} "
          f"(batch {args.batch}, {args.tokens} new tokens each; extras {sorted(extras)})")
    print("continuations:")
    for row in out[:, args.prompt_len:]:
        print("  ", row.tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
