"""Gradient compression with error feedback (port of
``repro.optim.compression``).

Two wire formats for the gradient reduction, both with f32 error-feedback
accumulators (the compression error is fed back into the next step's
gradient, which keeps SGD/Adam convergence — Seide et al. 1-bit SGD,
Karimireddy et al. EF-SGD):

  bf16   halve all-reduce bytes; the production default.
  int8   per-tensor symmetric quantization, 4x fewer bytes on the wire.

Trees are the port's (``adamw.named_leaves``): the new grads and error
state come back as flat ``{name: tensor}`` dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.adamw import named_leaves


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"  # none | bf16 | int8


def init_error_state(params: Any, cfg: CompressionConfig) -> dict[str, torch.Tensor] | None:
    if cfg.mode == "none":
        return None
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named_leaves(params).items()}


def compress(g: torch.Tensor, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (wire tensor, scale). Decompress with wire * scale."""
    if mode == "bf16":
        return g.to(torch.bfloat16), torch.ones((), dtype=torch.float32, device=g.device)
    if mode == "int8":
        scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(mode)


def decompress(wire: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return wire.to(torch.float32) * scale


def apply_error_feedback(
    grads: Any, error_state: dict[str, torch.Tensor] | None, cfg: CompressionConfig,
) -> tuple[Any, dict[str, torch.Tensor] | None, dict[str, torch.Tensor]]:
    """grads -> (decompressed grads as reduced on the wire, new error state).

    g_eff = compress(g + e);  e' = (g + e) - decompress(g_eff)
    """
    if cfg.mode == "none" or error_state is None:
        leaves = list(named_leaves(grads).values())
        dev = leaves[0].device if leaves else None
        return grads, error_state, {"compression_err": torch.zeros((), device=dev)}
    new_grads, new_err = {}, {}
    for name, g in named_leaves(grads).items():
        corrected = g.to(torch.float32) + error_state[name]
        restored = decompress(*compress(corrected, cfg.mode))
        new_grads[name], new_err[name] = restored, corrected - restored
    total = sum(torch.sum(torch.square(e)) for e in new_err.values())
    return new_grads, new_err, {"compression_err": total}
