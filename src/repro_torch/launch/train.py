"""Training launcher CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 300 \\
        --checkpoint-dir build/ckpt
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
    rm -rf build/mesh_ckpt  # a checkpoint left there would be restored
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen3-4b --mesh 2,2 --device cpu \\
        --steps 6 --global-batch 4 --seq-len 32 --checkpoint-dir build/mesh_ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen3-4b --mesh 2,2 --device cpu \\
        --steps 10 --global-batch 4 --seq-len 32 --restart-from build/mesh_ckpt \\
        --alive h0,h1 --dead h2,h3

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

``--mesh D,M`` (with ``--pod P``, a (pod, data, model) mesh) trains any
family on a ``(data, model)`` mesh, one process a rank under
``torch.distributed.run``: NCCL over the cards, or gloo with ``--device
cpu``.  ``--restart-from DIR --alive ... --dead ...`` is the elastic
restart: ``ElasticMeshPlanner`` (one rank a host, the model axis of
``--mesh``, the global batch) re-plans the mesh over the hosts left, the
run must have that many ranks, restores DIR's newest checkpoint onto the
new mesh and trains on to ``--steps``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.su3.plan import resolve_device
from repro_torch.distributed.fault_tolerance import ElasticMeshPlanner
from repro_torch.launch import mesh as meshes
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
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train on a (data, model) mesh of D x M ranks")
    ap.add_argument("--pod", type=int, default=None,
                    help="with --mesh, a (pod, data, model) mesh of P pods")
    ap.add_argument("--restart-from", default=None, metavar="DIR",
                    help="with --mesh: re-plan the mesh over --alive and restore DIR")
    ap.add_argument("--alive", default="", help="hosts left, comma-separated")
    ap.add_argument("--dead", default="", help="hosts lost, comma-separated")
    args = ap.parse_args(argv)
    if (args.pod or args.restart_from) and not args.mesh:
        ap.error("--pod and --restart-from need --mesh")

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
    if not args.mesh:
        out = train(cfg, tcfg, device=device)
        print(f"done; final loss {out['final_loss']}")
        return
    shape, axes = _mesh_shape(args)
    meshes.init_distributed(device)
    try:
        mesh = meshes.make_mesh(shape, axes, device=device.type)
        out = train(cfg, tcfg, mesh=mesh, restore_dir=args.restart_from)
        if torch.distributed.get_rank() == 0:
            print(f"done on mesh {dict(zip(axes, shape))}; final loss {out['final_loss']}")
    finally:
        torch.distributed.destroy_process_group()


def _mesh_shape(args: argparse.Namespace) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The mesh of ``--mesh`` / ``--pod``, or with ``--restart-from`` the
    planner's over the hosts left."""
    data, model = (int(n) for n in args.mesh.split(","))
    if args.restart_from:
        alive = [h for h in args.alive.split(",") if h]
        dead = [h for h in args.dead.split(",") if h]
        plan = ElasticMeshPlanner(devices_per_host=1, model_axis=model,
                                  global_batch=args.global_batch).plan(alive, dead)
        print(f"elastic re-plan: {plan}", flush=True)
        data, model = plan.data, plan.model
    if args.pod:
        return (args.pod, data, model), meshes.MULTI_POD_AXES
    return (data, model), meshes.PRODUCTION_AXES


if __name__ == "__main__":
    main()
