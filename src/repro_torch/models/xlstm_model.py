"""xLSTM LM stack: mLSTM blocks, with sLSTM blocks at ``cfg.slstm_layers``
(port of ``repro.models.xlstm_model``).

The stack is heterogeneous, so its parameters are a list of per-block
trees (``blocks``, two shapes), walked by a Python loop, as in the
reference.  Training remats each block with ``torch.utils.checkpoint``
(non-reentrant), the counterpart of the reference's
``jax.checkpoint(..., nothing_saveable)``: the backward recomputes one
block's time loop at a time, so one block's per-step tensors are held at
once.  The family reaches no kernel of the port: both cells are plain
PyTorch, as the reference writes them in plain jnp.

Decode state: one dict per block (``xlstm.mlstm_init_state`` or
``slstm_init_state``), O(1) in the sequence length.

On a mesh the residual stream is pinned to ``"btd"`` at the reference's
sites and the logits to ``"btv"``; each block runs the cells' mesh path
(``models/xlstm.py``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import common, xlstm
from repro_torch.models.common import ParamSpec, ParamTree


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return i in cfg.slstm_layers


def spec(cfg: ModelConfig) -> common.SpecTree:
    d, v = cfg.d_model, cfg.vocab_size
    blocks = []
    for i in range(cfg.n_layers):
        cell = xlstm.slstm_spec(cfg) if _is_slstm(cfg, i) else xlstm.mlstm_spec(cfg)
        blocks.append({"norm": ParamSpec((d,), ("embed",), init="ones"), "cell": cell})
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "blocks": blocks,
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), scale=0.02),
    }


def stack_sizes(cfg: ModelConfig) -> dict[str, int]:
    """No stacked leaves: ``blocks`` is a list in the reference's tree too."""
    return {}


def from_tree(cfg: ModelConfig, tree: dict[str, Any]) -> ParamTree:
    """The model of a tree shaped like :func:`spec` (``blocks`` becomes an
    ``nn.ModuleList``, whose parameters are named ``blocks.10.cell.w_up``)."""
    return ParamTree(tree)


def init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random weights on the generator's device by the reference's rule."""
    return from_tree(cfg, common.init_params(spec(cfg), generator, dtype))


def _block(bp, x: torch.Tensor, cfg: ModelConfig, i: int, state=None):
    apply = xlstm.slstm_apply if _is_slstm(cfg, i) else xlstm.mlstm_apply
    x = shard(x, "btd")
    y, new_state = apply(bp["cell"], common.rmsnorm(x, bp["norm"], cfg.norm_eps), cfg,
                         state=state)
    return shard(x + y, "btd"), new_state


def _block_out(bp, x: torch.Tensor, cfg: ModelConfig, i: int) -> torch.Tensor:
    """One state-less block's output: the unit that remat recomputes."""
    return _block(bp, x, cfg, i)[0]


def forward(
    params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *, state: list | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, list | None]:
    """Returns (hidden (B, S, d), the new per-block states or None)."""
    x = shard(common.embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype)),
              "btd")
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        if state is not None:
            x, st = _block(bp, x, cfg, i, state[i])
            new_states.append(st)
        elif remat:
            x = checkpoint(_block_out, bp, x, cfg, i, use_reentrant=False)
        else:
            x = _block_out(bp, x, cfg, i)
    return x, (new_states if state is not None else None)


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return shard(torch.matmul(h, params["lm_head"].to(h.dtype)), "btv")


def loss_fn(
    params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *, remat: bool = True, **_,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``batch["labels"]``; metrics ``nll`` and
    ``loss`` (the same value)."""
    x, _ = forward(params, batch, cfg, remat=remat)
    loss = common.softmax_cross_entropy(_logits(params, x, cfg), batch["labels"])
    return loss, {"nll": loss, "loss": loss}


def init_state(
    cfg: ModelConfig, batch: int, max_len: int = 0, dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> list[dict[str, torch.Tensor]]:
    """Zero states, one per block, in ``dtype`` (``max_len`` is unused: the
    state does not grow with the sequence)."""
    return [(xlstm.slstm_init_state if _is_slstm(cfg, i) else xlstm.mlstm_init_state)(
        cfg, batch, dtype, device) for i in range(cfg.n_layers)]


def prefill(
    params, batch: dict[str, torch.Tensor], state: list, cfg: ModelConfig, **_,
) -> tuple[torch.Tensor, list]:
    """The prompts from ``state``: last-position logits and the new state."""
    x, new_state = forward(params, batch, cfg, state=state)
    return _logits(params, x[:, -1:], cfg), new_state


def decode_step(
    params, batch: dict[str, torch.Tensor], state: list, cur_len: int, cfg: ModelConfig, **_,
) -> tuple[torch.Tensor, list]:
    """The given tokens from ``state`` (``cur_len`` is unused: the cells
    carry no position): logits at every given position and the new state."""
    x, new_state = forward(params, batch, cfg, state=state)
    return _logits(params, x, cfg), new_state
