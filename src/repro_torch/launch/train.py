"""Training launcher CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 300 \\
        --checkpoint-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --full-config --steps 5 --seq-len 1024 --global-batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --full-config --steps 5 --seq-len 1024 --global-batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --full-config --steps 5 --seq-len 1024 --global-batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --full-config --steps 5 --seq-len 448 --global-batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \\
        --full-config --n-layers 3 --steps 5 --seq-len 1024 --global-batch 2

Single-process entry point around ``train.loop`` on one card (``--device cpu``
runs the plain versions on the CPU); without ``--full-config`` it trains
the architecture's reduced config.  Every family trains: the dense and
MoE transformers (the MoE balance loss enters the loss with weight 0.01,
as in the reference), the zamba hybrid (a sequence of at most 128 tokens,
or a multiple of 128: the SSD's chunk), the xLSTM stack (each block
rematted) and the whisper encoder-decoder (random frame embeddings from
the data pipeline; each decoder layer rematted).  ``--n-layers`` cuts the
depth and keeps the width: deepseek-v3 at full width with 3 layers is its 3
dense layers (and the MTP layer), 4.29 B parameters, which train on one
card.  On the card a reduced MLA config keeps deepseek-v3's head dims (qk
128 + 64, v 128), the flash kernels' MLA pair (``mla.with_kernel_heads``).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import resolve_device
from repro_torch.models import mla
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config to its first N layers (width kept)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers,
                                  n_dense_layers=min(cfg.n_dense_layers, args.n_layers))
    device = resolve_device(args.device)
    if cfg.use_mla and device.type == "cuda":
        cfg = mla.with_kernel_heads(cfg)
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.global_batch,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        seed=args.seed, microbatches=args.microbatches,
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
    )
    out = train(cfg, tcfg, device=device)
    print(f"done; final loss {out['final_loss']}")


if __name__ == "__main__":
    main()
