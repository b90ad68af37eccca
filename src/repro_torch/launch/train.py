"""Training launcher CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 300 \\
        --checkpoint-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --full-config --steps 5 --seq-len 1024 --global-batch 2

Single-process entry point around ``train.loop`` on one card (``--device cpu``
runs the plain versions on the CPU); without ``--full-config`` it trains
the architecture's reduced config.  The dense and MoE families train (the
MoE balance loss enters the loss with weight 0.01, as in the reference).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, required=True)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
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
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.global_batch,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        seed=args.seed, microbatches=args.microbatches,
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
    )
    out = train(cfg, tcfg, device=args.device)
    print(f"done; final loss {out['final_loss']}")


if __name__ == "__main__":
    main()
