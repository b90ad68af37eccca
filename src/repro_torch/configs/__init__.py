"""Configurations: the LM architecture registry (``get_config("<arch-id>")``,
port of ``repro.configs``) and the SU3_Bench lattice configurations
(``repro_torch.configs.su3_bench``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES = {
    "internvl2-26b": "internvl2_26b",
    "granite-34b": "granite_34b",
    "qwen3-4b": "qwen3_4b",
    "minitron-8b": "minitron_8b",
    "yi-6b": "yi_6b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "xlstm-125m": "xlstm_125m",
    "whisper-tiny": "whisper_tiny",
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ALL_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "shape_applicable"]
