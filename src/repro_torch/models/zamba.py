"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* attention block
applied after every k layers (port of ``repro.models.zamba``).

The one block's weights serve every application (the Zamba/Zamba2
signature), so its gradient is the sum over the applications, which
autograd forms; each application keeps its own KV cache.  With
``n_layers = n_groups * k + tail`` the layers run in groups of k, each
group followed by the shared block, then the tail without it.

The reference stacks the Mamba2 layers' parameters (``mamba_layers``) and
scans each group; here they are an ``nn.ModuleList`` of per-layer trees
walked by a Python loop, and training remats each Mamba2 layer with
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint(..., nothing_saveable)`` scan body.  The
shared block's attention is :func:`repro_torch.models.attention.apply`:
on the card its prefill and training forward are the flash kernel
(``csrc/flash_attention.cu``), its training backward the flash backward
kernel; decode is plain PyTorch.

Decode state, per layer and per application (the reference stacks both):
  {"mamba": [n_layers x {"ssm": (B, H, P, N), "conv": (B, K-1, conv_dim)}],
   "attn":  [n_groups x {"k", "v": (B, S, Hkv, hd)}]}
The Mamba2 states are f32 whatever the cache dtype, as the reference's
``mamba2.state_spec`` makes them.  A call with a state puts each layer's
new Mamba2 state in its list and writes the KV caches in place, and
returns the same state.

On a mesh (DTensor parameters, ``distributed.act_sharding.use_rules``) the
residual stream is pinned to ``"btd"`` at the reference's sites and the
logits to ``"btv"``; each Mamba2 layer runs ``mamba2._apply_mesh`` and the
shared block the DTensor branches of ``attention`` and ``ffn``; each
application's cache lies at its state rule (``registry.init_state(...,
mesh=)``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import attention, common, ffn, mamba2
from repro_torch.models.common import ParamSpec, ParamTree


def _counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, n_tail). layers = n_groups*k + tail."""
    k = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // k
    return n_groups, k, cfg.n_layers - n_groups * k


def mamba_layer_spec(cfg: ModelConfig) -> common.SpecTree:
    return {
        "norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": mamba2.spec(cfg),
    }


def shared_block_spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attention.spec(cfg),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn": ffn.spec(cfg),
    }


def spec(cfg: ModelConfig) -> common.SpecTree:
    """The reference's tree: ``mamba_layers`` stacked over a leading layer
    dim, ``shared_attn`` one set of weights."""
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "mamba_layers": common.stack_specs(mamba_layer_spec(cfg), cfg.n_layers),
        "shared_attn": shared_block_spec(cfg),  # ONE param set, many applications
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), scale=0.02),
    }


def stack_sizes(cfg: ModelConfig) -> dict[str, int]:
    """``{tree key: layer count}`` of the stacked leaves: ``mamba_layers``."""
    return {"mamba_layers": cfg.n_layers}


def from_tree(cfg: ModelConfig, tree: dict[str, Any]) -> ParamTree:
    """The model of a tree shaped like :func:`spec`: the stacked
    ``mamba_layers`` become one sub-tree per layer."""
    tree = dict(tree)
    tree["mamba_layers"] = common.unstack(tree["mamba_layers"], cfg.n_layers)
    return ParamTree(tree)


def init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random weights on the generator's device, by the reference's rule
    (:func:`repro_torch.models.common.init_params`: a stacked leaf takes
    1/sqrt(n_layers))."""
    return from_tree(cfg, common.init_params(spec(cfg), generator, dtype))


def _mamba_block(lp, x: torch.Tensor, cfg: ModelConfig, state=None):
    x = shard(x, "btd")
    h = common.rmsnorm(x, lp["norm"], cfg.norm_eps)
    y, new_state = mamba2.apply(lp["mixer"], h, cfg, state=state)
    return shard(x + y, "btd"), new_state


def _mamba_out(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One state-less Mamba2 layer's output: the unit that remat recomputes."""
    return _mamba_block(lp, x, cfg)[0]


def _shared_block(sp, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, cache=None,
                  cur_len: int | None = None, q_chunk: int = 512, kv_chunk: int = 1024):
    h = common.rmsnorm(x, sp["attn_norm"], cfg.norm_eps)
    a, cache = attention.apply(sp["attn"], h, cfg, positions=positions, cache=cache,
                               cur_len=cur_len, q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + a
    h = common.rmsnorm(x, sp["ffn_norm"], cfg.norm_eps)
    return x + ffn.apply(sp["ffn"], h), cache


def forward(
    params,
    batch: dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    state: dict[str, Any] | None = None,
    cur_len: int | None = None,
    remat: bool = False,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, Any] | None]:
    """Returns (hidden (B, S, d), state).  Positions are ``cur_len +
    arange(S)`` (0 without a state).  ``remat`` (training, no state)
    recomputes each Mamba2 layer in the backward from its input; the
    shared block is not rematted, as in the reference."""
    b, s = batch["tokens"].shape
    dev = batch["tokens"].device
    start = 0 if cur_len is None else int(cur_len)
    positions = (start + torch.arange(s, device=dev)).expand(b, s)
    x = shard(common.embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype)),
              "btd")
    k = cfg.hybrid_attn_every
    for i, lp in enumerate(params["mamba_layers"]):
        if state is not None:
            x, state["mamba"][i] = _mamba_block(lp, x, cfg, state["mamba"][i])
        elif remat:
            x = checkpoint(_mamba_out, lp, x, cfg, use_reentrant=False)
        else:
            x = _mamba_out(lp, x, cfg)
        if (i + 1) % k == 0:  # the end of a group: the shared block (the tail has none)
            cache = state["attn"][(i + 1) // k - 1] if state is not None else None
            x, _ = _shared_block(params["shared_attn"], x, cfg, positions, cache=cache,
                                 cur_len=cur_len, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return x, state


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return shard(torch.matmul(h, params["lm_head"].to(h.dtype)), "btv")


def loss_fn(
    params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *, remat: bool = True,
    q_chunk: int = 512, kv_chunk: int = 1024, **_,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``batch["labels"]``; metrics ``nll`` and
    ``loss`` (the same value: the hybrid has no auxiliary loss)."""
    x, _ = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk)
    loss = common.softmax_cross_entropy(_logits(params, x, cfg), batch["labels"])
    return loss, {"nll": loss, "loss": loss}


def init_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """f32 Mamba2 states per layer, ``dtype`` KV caches per application."""
    n_groups, _, _ = _counts(cfg)
    kv_len = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    return {
        "mamba": [mamba2.init_state(cfg, batch, torch.float32, device)
                  for _ in range(cfg.n_layers)],
        "attn": [attention.init_cache(cfg, batch, kv_len, dtype, device) for _ in range(n_groups)],
    }


def prefill(
    params, batch: dict[str, torch.Tensor], state: dict[str, Any], cfg: ModelConfig,
    *, q_chunk: int = 512, kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Writes the state from position 0 and returns last-position logits.
    The prompt length must be at most 128 or a multiple of 128 (the SSD's
    chunk; ``ValueError`` otherwise)."""
    x, state = forward(params, batch, cfg, state=state, cur_len=0, q_chunk=q_chunk,
                       kv_chunk=kv_chunk)
    return _logits(params, x[:, -1:], cfg), state


def decode_step(
    params, batch: dict[str, torch.Tensor], state: dict[str, Any], cur_len: int,
    cfg: ModelConfig, *, q_chunk: int = 512, kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """The tokens at ``cur_len ..`` from the state: one token runs the
    Mamba2 recurrence and attends over the cache; more run the chunked SSD
    from the state, and their attention (as in the reference) sees their
    own keys only.  Returns logits at every given position."""
    x, state = forward(params, batch, cfg, state=state, cur_len=cur_len, q_chunk=q_chunk,
                       kv_chunk=kv_chunk)
    return _logits(params, x, cfg), state
