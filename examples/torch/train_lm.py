"""Training on the port: a reduced LM through ``train.loop.train`` with
checkpointing and loss tracking.

    PYTHONPATH=src python examples/torch/train_lm.py --arch qwen3-4b --steps 300
    PYTHONPATH=src python examples/torch/train_lm.py --arch internvl2-26b --steps 20 --device cpu

The data pipeline adds the stub inputs a family needs (patches, frames).
On the card an MLA config keeps deepseek-v3's head dims, the flash
kernels' MLA pair.
"""
import argparse

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import cli_device
from repro_torch.models import mla
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = cli_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.use_mla and dev.type == "cuda":
        cfg = mla.with_kernel_heads(cfg)
    print(f"arch {args.arch} (reduced: {cfg.n_layers}L d{cfg.d_model}, "
          f"~{cfg.n_params() / 1e6:.1f}M params) on {dev}")
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.batch,
        checkpoint_dir=args.checkpoint_dir, log_every=max(1, min(20, args.steps // 5)),
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(1, args.steps // 10),
                        total_steps=args.steps),
    )
    out = train(cfg, tcfg, device=dev)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.2 else 'check hyperparams'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
