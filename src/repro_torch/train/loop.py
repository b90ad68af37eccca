"""The training loop: restore-or-init, step, checkpoint, fault hooks (port
of ``repro.train.loop``).

The single-process loop behind ``launch/train.py``, the examples and the
tests: it runs on the card unless told otherwise (``device=None`` means
CUDA and raises without it; ``"cpu"`` runs the plain versions).  Init draws
the weights from a ``torch.Generator`` seeded by ``TrainConfig.seed`` on
the device (torch's numbers, not ``jax.random``'s) in f32, the master
weights; the model computes in ``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.su3.plan import resolve_device
from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.models import common, registry
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    *,
    log: Callable[[str], None] = print,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """Train from scratch or from the newest checkpoint in
    ``tcfg.checkpoint_dir`` up to ``tcfg.steps`` steps.

    Returns ``params`` and ``opt_state`` (on the device), ``losses`` (the
    loss at each logged step, as the reference), ``final_loss``, and the
    steps this call ran: ``history`` (per step: ``step``, ``loss``, ``nll``,
    ``aux``, ``grad_norm``, ``lr``) and ``step_ms`` (between CUDA events on the
    card, the host clock on the CPU).
    """
    dev = resolve_device(device)
    api = registry.get(cfg)
    pipe = TokenPipeline(
        DataConfig(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed)
    )
    params = common.trainable(api.init(torch.Generator(device=dev).manual_seed(tcfg.seed), cfg))
    opt_state = adamw.init(params, tcfg.opt)
    pstate = PipelineState()
    start_step = 0

    ckpt = None
    if tcfg.checkpoint_dir:
        ckpt = CheckpointManager(CheckpointConfig(tcfg.checkpoint_dir))
        if ckpt.latest_step() is not None:
            _, extra, start_step = ckpt.restore((params, opt_state))
            pstate = PipelineState(step=int(extra.get("pipeline_step", start_step)))
            log(f"restored checkpoint at step {start_step}")

    step_fn = make_train_step(cfg, tcfg.opt, microbatches=tcfg.microbatches,
                              q_chunk=min(512, tcfg.seq_len), kv_chunk=min(1024, tcfg.seq_len))
    monitor = HeartbeatMonitor(["host0"])
    losses: list[float] = []
    steps: list[tuple[int, dict[str, torch.Tensor]]] = []
    clocks: list[tuple[Any, Any]] = []
    t_last = time.perf_counter()
    for step in range(start_step, tcfg.steps):
        batch, pstate = make_train_batch(pipe, pstate, cfg, device=dev)
        t0 = _clock(dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        clocks.append((t0, _clock(dev)))
        steps.append((step + 1, {k: metrics[k] for k in ("loss", "nll", "aux", "grad_norm", "lr")}))
        if (step + 1) % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            now = time.perf_counter()
            monitor.beat("host0", step_time_s=(now - t_last) / tcfg.log_every)
            t_last = now
            log(f"step {step + 1:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e}")
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(step + 1, (params, opt_state), {"pipeline_step": pstate.step})
    if ckpt:
        ckpt.save(tcfg.steps, (params, opt_state), {"pipeline_step": pstate.step})
        ckpt.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {
        "params": params, "opt_state": opt_state, "losses": losses,
        "final_loss": losses[-1] if losses else None,
        "history": [{"step": s, **{k: float(v) for k, v in m.items()}} for s, m in steps],
        "step_ms": [_ms(dev, a, b) for a, b in clocks],
    }


def _clock(dev: torch.device) -> Any:
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(dev: torch.device, a: Any, b: Any) -> float:
    return a.elapsed_time(b) if dev.type == "cuda" else (b - a) * 1e3
