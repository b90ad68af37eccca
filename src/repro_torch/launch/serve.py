"""Serving launcher CLI (port of ``repro.launch.serve``), on the reduced
config of an architecture with random weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-34b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu

Every family runs: the dense and MoE transformers (granite-moe-1b-a400m:
32 experts, top-8 softmax routing; deepseek-v3-671b: MLA, a leading dense
layer, sigmoid aux-free routing and a shared expert), the zamba hybrid
(zamba2-1.2b: Mamba2 layers and one shared attention block; a prompt of at
most 128 tokens, or a multiple of 128, the SSD's chunk), the xLSTM stack
(xlstm-125m: mLSTM and sLSTM blocks, one time step at a time) and the
whisper encoder-decoder (whisper-tiny: random frame embeddings stand in
for the stubbed conv front end, as in the reference); granite-34b's
reduced config keeps its MQA (one kv head).  On the card an MLA
config keeps deepseek-v3's head dims (qk 128 + 64, v 128), the flash
kernel's one MLA pair (``mla.with_kernel_heads``); on the CPU it is
reduced like the others.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import resolve_device
from repro_torch.models import mla, registry
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
    if cfg.use_mla and device.type == "cuda":
        cfg = mla.with_kernel_heads(cfg)
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
    # the stub inputs are drawn on the CPU and moved, so both devices serve the same ones
    extras = {}
    if cfg.n_patches:
        extras["patches"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model),
            generator=torch.Generator().manual_seed(9)).to(device)
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.randn(
            (args.batch, cfg.encoder_len, cfg.d_model),
            generator=torch.Generator().manual_seed(10)).to(device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.tokens, extras=extras or None)
    dt = time.perf_counter() - t0
    print(f"{args.arch}: {out.shape[0]}x{args.tokens} tokens in {dt:.2f}s "
          f"({out.shape[0] * args.tokens / dt:.1f} tok/s on {device}, first call)")


if __name__ == "__main__":
    main()
