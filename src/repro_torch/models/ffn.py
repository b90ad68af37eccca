"""Dense FFN (SwiGLU, LLaMA-style) and the GELU variant for Whisper (port of
``repro.models.ffn``).  Weights are narrowed to the activations' dtype at
each use, as the reference does; on a mesh the hidden activations are
pinned to ``"btf"`` at the reference's sites."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def spec(cfg: ModelConfig, d_ff: int | None = None) -> common.SpecTree:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def apply(params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = shard(torch.matmul(x, params["w_gate"].to(dt)), "btf")
    up = shard(torch.matmul(x, params["w_up"].to(dt)), "btf")
    return torch.matmul(torch.nn.functional.silu(gate) * up, params["w_down"].to(dt))


def spec_gelu(cfg: ModelConfig) -> common.SpecTree:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": ParamSpec((d, f), ("embed", "mlp")),
        "b_in": ParamSpec((f,), ("mlp",), init="zeros"),
        "w_out": ParamSpec((f, d), ("mlp", "embed")),
        "b_out": ParamSpec((d,), ("embed",), init="zeros"),
    }


def apply_gelu(params, x: torch.Tensor) -> torch.Tensor:
    """GELU FFN; ``jax.nn.gelu``'s default is the tanh approximation."""
    dt = x.dtype
    h = shard(torch.matmul(x, params["w_in"].to(dt)) + params["b_in"].to(dt), "btf")
    return (torch.matmul(torch.nn.functional.gelu(h, approximate="tanh"), params["w_out"].to(dt))
            + params["b_out"].to(dt))
