"""Decoder-only LM assembly, the dense path (port of
``repro.models.transformer``).

The reference stacks each parameter over the layers and drives the stack
with ``lax.scan``; here the layers are an ``nn.ModuleList`` of per-layer
parameter trees walked by a Python loop, and the decode state is a list of
per-layer KV caches updated in place.  Training remats each layer with
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint(..., nothing_saveable)`` scan body: a layer
keeps only its input and recomputes the rest in the backward.  MoE FFNs and
MLA attention raise ``NotImplementedError`` (ROADMAP Queue 1, the MoE and
MLA items).

API (uniform across families via models.registry):
  spec(cfg) / init(generator, cfg)       params
  loss_fn(params, batch, cfg)            train forward -> (loss, metrics)
  prefill(params, batch, state, cfg)     -> (logits, state)
  decode_step(params, batch, state, cur_len, cfg) -> (logits, state)
  init_state(cfg, batch, max_len)        per-layer KV caches
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn
from repro_torch.models.common import ParamSpec, ParamTree

MOE_TODO = "MoE FFN layers are not ported yet (ROADMAP Queue 1, the MoE item: granite-moe-1b)"
MLA_TODO = "MLA attention is not ported yet (ROADMAP Queue 1, the MLA item: deepseek-v3)"


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.use_mla:
        raise NotImplementedError(MLA_TODO)
    if cfg.is_moe:
        raise NotImplementedError(MOE_TODO)


# ---------------------------------------------------------------------------
# Layer spec/apply
# ---------------------------------------------------------------------------


def layer_spec(cfg: ModelConfig, *, moe_layer: bool = False) -> common.SpecTree:
    if moe_layer:
        raise NotImplementedError(MOE_TODO)
    _check_dense(cfg)
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attention.spec(cfg),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn": ffn.spec(cfg),
    }


def layer_apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: dict[str, torch.Tensor] | None = None,
    cur_len: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Pre-norm block. Returns (x, cache)."""
    h = common.rmsnorm(x, params["attn_norm"], cfg.norm_eps)
    a, cache = attention.apply(
        params["attn"], h, cfg, positions=positions, cache=cache, cur_len=cur_len,
        q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    x = x + a
    h = common.rmsnorm(x, params["ffn_norm"], cfg.norm_eps)
    return x + ffn.apply(params["ffn"], h), cache


# ---------------------------------------------------------------------------
# Model spec
# ---------------------------------------------------------------------------


def spec(cfg: ModelConfig) -> common.SpecTree:
    """The reference's tree: ``layers`` holds every layer leaf stacked over a
    leading ``(n_layers,)`` dim."""
    d, v = cfg.d_model, cfg.vocab_size
    s: common.SpecTree = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "layers": common.stack_specs(layer_spec(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), scale=0.02)
    if cfg.mtp_depth:
        s["mtp"] = {
            "proj": ParamSpec((2 * d, d), ("embed", None)),
            "norm_h": ParamSpec((d,), ("embed",), init="ones"),
            "norm_e": ParamSpec((d,), ("embed",), init="ones"),
            "layer": layer_spec(cfg),
        }
    return s


def from_tree(cfg: ModelConfig, tree: dict[str, Any]) -> ParamTree:
    """The model of a tree shaped like :func:`spec` (stacked ``layers``):
    the stacked leaves become one sub-tree per layer."""
    tree = dict(tree)
    tree["layers"] = common.unstack(tree["layers"], cfg.n_layers)
    return ParamTree(tree)


def init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random weights on the generator's device, by the reference's rule
    (:func:`repro_torch.models.common.init_params`)."""
    return from_tree(cfg, common.init_params(spec(cfg), generator, dtype))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch: dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    x = common.embed_lookup(params["embed"], batch["tokens"]).to(getattr(torch, cfg.dtype))
    if cfg.n_patches and "patches" in batch:
        # VLM stub frontend: precomputed patch embeddings replace the first
        # n_patches sequence positions (input_specs provides them).
        p = batch["patches"].to(x.dtype)
        x = torch.cat([p, x[:, cfg.n_patches:]], dim=1)
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w.to(h.dtype))


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
) -> tuple[torch.Tensor, dict[str, Any] | None, torch.Tensor]:
    """Returns (hidden (B,S,d), state, aux).  With a state, each layer's
    cache is written in place at ``cur_len`` and the same state returned;
    aux is the MoE balance loss, 0 on the dense path.  ``remat`` (training,
    no state) recomputes each layer in the backward from its input."""
    b, s = batch["tokens"].shape
    dev = batch["tokens"].device
    start = 0 if cur_len is None else int(cur_len)
    positions = (start + torch.arange(s, device=dev)).expand(b, s)
    x = _embed_inputs(params, batch, cfg)
    caches = state["dense"] if state is not None else [None] * cfg.n_layers
    for lp, cache in zip(params["layers"], caches):
        x = common.grad_safe_barrier(x)
        if remat:
            x = checkpoint(_layer_out, lp, x, cfg, positions, q_chunk, kv_chunk,
                           use_reentrant=False)
        else:
            x, _ = layer_apply(lp, x, cfg, positions=positions, cache=cache, cur_len=cur_len,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    return x, state, torch.zeros((), dtype=torch.float32, device=dev)


def _layer_out(lp, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, q_chunk: int,
               kv_chunk: int) -> torch.Tensor:
    """One cache-less layer's output: the unit that remat recomputes."""
    return layer_apply(lp, x, cfg, positions=positions, q_chunk=q_chunk, kv_chunk=kv_chunk)[0]


# ---------------------------------------------------------------------------
# Train / serve entry points
# ---------------------------------------------------------------------------


def loss_fn(
    params,
    batch: dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    remat: bool = True,
    aux_weight: float = 0.01,
    mtp_weight: float = 0.3,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The training loss, as the reference's: mean next-token NLL over
    ``batch["labels"]`` plus ``aux_weight * aux`` (0 on the dense path)
    and, with ``cfg.mtp_depth`` and ``batch["labels2"]``, ``mtp_weight``
    times the MTP head's NLL on the token after next.

    Returns (total, metrics) with metrics ``nll``, ``aux``, ``loss`` and
    ``mtp_nll`` where the head runs; each is a 0-dim f32 tensor in the
    graph (the caller detaches).
    """
    _check_dense(cfg)
    x, _, aux = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk)
    logits = _logits(params, x, cfg)
    loss = common.softmax_cross_entropy(logits, batch["labels"])
    del logits
    metrics = {"nll": loss, "aux": aux}
    total = loss + aux_weight * aux
    if cfg.mtp_depth and "labels2" in batch:
        # DeepSeek-V3 MTP: predict t+2 from h_t and embed(label_t (=token t+1))
        m = params["mtp"]
        e_next = common.embed_lookup(params["embed"], batch["labels"]).to(x.dtype)
        h_in = torch.cat([common.rmsnorm(x, m["norm_h"], cfg.norm_eps),
                          common.rmsnorm(e_next, m["norm_e"], cfg.norm_eps)], dim=-1)
        h_in = torch.matmul(h_in, m["proj"].to(x.dtype))
        b, s = batch["tokens"].shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        h_mtp, _ = layer_apply(m["layer"], h_in, cfg, positions=positions, q_chunk=q_chunk,
                               kv_chunk=kv_chunk)
        mtp_loss = common.softmax_cross_entropy(_logits(params, h_mtp, cfg), batch["labels2"])
        metrics["mtp_nll"] = mtp_loss
        total = total + mtp_weight * mtp_loss
    metrics["loss"] = total
    return total, metrics


def init_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """One KV cache per layer: ``{"dense": [{"k", "v"} (B, max_len, Hkv, hd)]}``."""
    _check_dense(cfg)
    return {"dense": [attention.init_cache(cfg, batch, max_len, dtype, device)
                      for _ in range(cfg.n_layers)]}


def prefill(
    params, batch: dict[str, torch.Tensor], state: dict[str, Any], cfg: ModelConfig,
    *, q_chunk: int = 512, kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Prefill writes the cache and returns last-position logits."""
    x, state, _ = forward(params, batch, cfg, state=state, cur_len=0, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return _logits(params, x[:, -1:], cfg), state


def decode_step(
    params, batch: dict[str, torch.Tensor], state: dict[str, Any], cur_len: int,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """One-token decode: batch['tokens'] is (B, 1)."""
    x, state, _ = forward(params, batch, cfg, state=state, cur_len=cur_len)
    return _logits(params, x, cfg), state
