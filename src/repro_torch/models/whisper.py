"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``).
The conv front end is stubbed, as in the reference: the model takes
precomputed frame embeddings (``batch["frames"]``, (B, encoder_len, d)).

Encoder: non-causal self-attention + GELU FFN over the frames.
Decoder: causal self-attention + cross-attention over the encoder's output
+ GELU FFN.  Sinusoidal positions on both sides (the reference's choice:
Whisper's learned decoder table stops at 448 positions).

Every attention over a sequence goes through
:func:`repro_torch.models.attention.flash_attention`: on the card the flash
kernel (``csrc/flash_attention.cu``; its backward kernel in training), on
the CPU the chunked plain version.  Decode attends over the self cache and
over all encoder rows of the cross cache with
:func:`~repro_torch.models.attention.decode_attention` (plain PyTorch, as in
the reference).  Training remats each decoder layer
(``torch.utils.checkpoint``, non-reentrant), as the reference checkpoints
its decoder scan's body; the encoder is not rematted.

The reference stacks each side's layers (``enc_layers``, ``dec_layers``)
and scans them; here they are ``nn.ModuleList``\\ s walked by a Python loop.
Decode state, stacked over the decoder layers as the reference's:
  {"self_k", "self_v": (L, B, max_len, H, hd),
   "cross_k", "cross_v": (L, B, encoder_len, H, hd)}
Prefill fills the cross K/V from the encoder's output once; a call writes
the caches in place and returns the same state.

On a mesh (DTensor parameters, ``distributed.act_sharding.use_rules``)
q, k and v are pinned to ``"bthd"`` at the reference's sites, so every
attention runs the flash kernel on each rank's heads
(``attention._local_heads``), and the logits to ``"btv"``.  The stacked
caches lie at ``state_placements`` (the reference's ``state_shardings``):
each layer is written in each rank's local shard (``attention.layer_cache``,
``write_cache``), and decode reads it there (``attention._decode``: each
rank's heads, or, on a cache split along its sequence, each rank's
partial softmax combined).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import attention, common, ffn
from repro_torch.models.common import ParamSpec, ParamTree

# log(10000) in f32, as the reference's jnp.log(10000.0) gives it
_LOG_1E4 = np.log(np.float32(10000.0))


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) f32: sin then cos of ``positions`` times d/2 frequencies
    from 1 down to 1/10000."""
    half = d // 2
    step = float(_LOG_1E4 / np.float32(max(half - 1, 1)))  # an f32 quotient, as the reference's
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device) * step)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _xattn_spec(cfg: ModelConfig) -> common.SpecTree:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wv": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }


def _enc_layer_spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "attn": _xattn_spec(cfg),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn": ffn.spec_gelu(cfg),
    }


def _dec_layer_spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    return {
        "self_norm": ParamSpec((d,), ("embed",), init="ones"),
        "self": _xattn_spec(cfg),
        "cross_norm": ParamSpec((d,), ("embed",), init="ones"),
        "cross": _xattn_spec(cfg),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn": ffn.spec_gelu(cfg),
    }


def spec(cfg: ModelConfig) -> common.SpecTree:
    """The reference's tree: ``enc_layers`` and ``dec_layers`` stacked over
    a leading layer dim."""
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "enc_layers": common.stack_specs(_enc_layer_spec(cfg), cfg.n_encoder_layers),
        "enc_norm": ParamSpec((d,), ("embed",), init="ones"),
        "dec_layers": common.stack_specs(_dec_layer_spec(cfg), cfg.n_layers),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, v), ("embed", "vocab"), scale=0.02),
    }


def stack_sizes(cfg: ModelConfig) -> dict[str, int]:
    """``{tree key: layer count}`` of the stacked leaves."""
    return {"enc_layers": cfg.n_encoder_layers, "dec_layers": cfg.n_layers}


def from_tree(cfg: ModelConfig, tree: dict[str, Any]) -> ParamTree:
    """The model of a tree shaped like :func:`spec`: each stack becomes one
    sub-tree per layer."""
    tree = dict(tree)
    for key, n in stack_sizes(cfg).items():
        tree[key] = common.unstack(tree[key], n)
    return ParamTree(tree)


def init(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random weights on the generator's device, by the reference's rule
    (a stacked leaf takes 1/sqrt(layer count))."""
    return from_tree(cfg, common.init_params(spec(cfg), generator, dtype))


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's heads by ``w`` (d, h, hd), pinned to ``"bthd"``."""
    return shard(attention._proj_in(x, w), "bthd")


def _mha(params, xq: torch.Tensor, xkv: torch.Tensor, *, causal: bool, q_chunk: int,
         kv_chunk: int) -> torch.Tensor:
    q, k, v = _heads(xq, params["wq"]), _heads(xkv, params["wk"]), _heads(xkv, params["wv"])
    out = attention.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return attention._proj_out(out, params["wo"])


def _embed(params, tokens: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = common.embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    return x + _sinusoid(positions, cfg.d_model).to(x.dtype)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, q_chunk: int = 512,
           kv_chunk: int = 1024) -> torch.Tensor:
    """The encoder over ``frames`` (B, F, d): (B, F, d) in ``cfg.dtype``."""
    f = frames.shape[1]
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + _sinusoid(torch.arange(f, device=x.device), cfg.d_model)[None].to(x.dtype)
    for lp in params["enc_layers"]:
        h = common.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + _mha(lp["attn"], h, h, causal=False, q_chunk=q_chunk, kv_chunk=kv_chunk)
        h = common.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn.apply_gelu(lp["ffn"], h)
    return common.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig, q_chunk: int,
               kv_chunk: int) -> torch.Tensor:
    """One decoder layer without a cache: the unit that remat recomputes."""
    h = common.rmsnorm(x, lp["self_norm"], cfg.norm_eps)
    x = x + _mha(lp["self"], h, h, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    h = common.rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
    x = x + _mha(lp["cross"], h, enc, causal=False, q_chunk=q_chunk, kv_chunk=kv_chunk)
    h = common.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + ffn.apply_gelu(lp["ffn"], h)


def forward_train(
    params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *, remat: bool = False,
    q_chunk: int = 512, kv_chunk: int = 1024,
) -> torch.Tensor:
    """The decoder's hidden states (B, S, d) over ``batch["tokens"]``,
    attending over the encoded ``batch["frames"]``."""
    enc = encode(params, batch["frames"], cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, s = batch["tokens"].shape
    x = _embed(params, batch["tokens"], torch.arange(s, device=enc.device), cfg)
    for lp in params["dec_layers"]:
        if remat:
            x = checkpoint(_dec_layer, lp, x, enc, cfg, q_chunk, kv_chunk, use_reentrant=False)
        else:
            x = _dec_layer(lp, x, enc, cfg, q_chunk, kv_chunk)
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return shard(torch.matmul(h, params["lm_head"].to(h.dtype)), "btv")


def loss_fn(
    params, batch: dict[str, torch.Tensor], cfg: ModelConfig, *, remat: bool = True,
    q_chunk: int = 512, kv_chunk: int = 1024, **_,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``batch["labels"]``; metrics ``nll`` and
    ``loss`` (the same value)."""
    x = forward_train(params, batch, cfg, remat=remat, q_chunk=q_chunk, kv_chunk=kv_chunk)
    loss = common.softmax_cross_entropy(_logits(params, x, cfg), batch["labels"])
    return loss, {"nll": loss, "loss": loss}


def init_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    """Zero self K/V caches of ``max_len`` rows and cross K/V of
    ``encoder_len`` rows per decoder layer, in ``dtype`` (the reference's
    default is bf16; ``ServeEngine`` passes its ``cache_dtype``)."""
    h, hd, f, n = cfg.n_heads, cfg.head_dim, cfg.encoder_len, cfg.n_layers
    kv, cross = (n, batch, max_len, h, hd), (n, batch, f, h, hd)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in (("self_k", kv), ("self_v", kv), ("cross_k", cross),
                                ("cross_v", cross))}


def prefill(
    params, batch: dict[str, torch.Tensor], state: dict[str, torch.Tensor], cfg: ModelConfig,
    *, q_chunk: int = 512, kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Encode the frames, fill the cross K/V from the encoder's output, run
    the prompts' causal self-attention (positions from 0) writing the self
    cache; returns last-position logits and the state."""
    enc = encode(params, batch["frames"], cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
    s = batch["tokens"].shape[1]
    x = _embed(params, batch["tokens"], torch.arange(s, device=enc.device), cfg)
    layer = attention.layer_cache
    for i, lp in enumerate(params["dec_layers"]):
        h = common.rmsnorm(x, lp["self_norm"], cfg.norm_eps)
        q, k, v = (_heads(h, lp["self"][w]) for w in ("wq", "wk", "wv"))
        attention.write_cache(layer(state["self_k"], i), k, 0)
        attention.write_cache(layer(state["self_v"], i), v, 0)
        out = attention.flash_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
        x = x + attention._proj_out(out, lp["self"]["wo"])
        h = common.rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        # the cross K/V in the cache's dtype, written, and attended as the cache holds them
        ck = _heads(enc, lp["cross"]["wk"]).to(state["cross_k"].dtype)
        cv = _heads(enc, lp["cross"]["wv"]).to(state["cross_v"].dtype)
        attention.write_cache(layer(state["cross_k"], i), ck, 0)
        attention.write_cache(layer(state["cross_v"], i), cv, 0)
        qx = _heads(h, lp["cross"]["wq"])
        out = attention.flash_attention(qx, ck.to(x.dtype), cv.to(x.dtype), causal=False,
                                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        x = x + attention._proj_out(out, lp["cross"]["wo"])
        h = common.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn.apply_gelu(lp["ffn"], h)
    return _logits(params, x[:, -1:], cfg), state


def decode_step(
    params, batch: dict[str, torch.Tensor], state: dict[str, torch.Tensor], cur_len: int,
    cfg: ModelConfig, **_,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token per row at position ``cur_len``: self-attention over the
    cache's first ``cur_len + 1`` rows, cross-attention over all encoder
    rows.  Returns its logits (B, 1, V) and the state."""
    b, s = batch["tokens"].shape
    if s != 1:
        raise ValueError(f"whisper decode_step takes one token per row, got {s}")
    cur, dt = int(cur_len), getattr(torch, cfg.dtype)
    x = _embed(params, batch["tokens"],
               torch.full((b, 1), float(cur), device=batch["tokens"].device), cfg)
    f = state["cross_k"].shape[2]
    layer = attention.layer_cache
    for i, lp in enumerate(params["dec_layers"]):
        h = common.rmsnorm(x, lp["self_norm"], cfg.norm_eps)
        q, k, v = (_heads(h, lp["self"][w]) for w in ("wq", "wk", "wv"))
        attention.write_cache(layer(state["self_k"], i), k, cur)
        attention.write_cache(layer(state["self_v"], i), v, cur)
        out = attention._decode(q, layer(state["self_k"], i).to(dt),
                                layer(state["self_v"], i).to(dt), cur + 1)
        x = x + attention._proj_out(out, lp["self"]["wo"])
        h = common.rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        qx = _heads(h, lp["cross"]["wq"])
        out = attention._decode(qx, layer(state["cross_k"], i).to(dt),
                                layer(state["cross_v"], i).to(dt), f)
        x = x + attention._proj_out(out, lp["cross"]["wo"])
        h = common.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + ffn.apply_gelu(lp["ffn"], h)
    return _logits(params, x, cfg), state
