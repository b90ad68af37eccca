"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of ``repro.models.mla``).

Low-rank q (``w_dq`` -> norm -> ``w_uq``), latent kv compression (``w_dc``
-> norm) with a decoupled, head-less RoPE channel (``w_dr``: one k_rope
shared by every head), and two formulations of the same attention:

  * prefill and training decompress K's nope part and V per head from the
    latent and run ``flash_attention_split`` on the parts as they are made:
    q_nope, q_rope, k_nope, the one k_rope channel that every head shares,
    and v (a qk head of nope + rope, 192 at full width, and a v head of
    128).  On the card that is the hand-written kernel at (D, Dv) = (192,
    128) (``csrc/flash_attention.cu``, ``flash_mla_fwd``, one launch per
    layer), which reads each part in place: neither q nor k is
    concatenated, nor k_rope copied per head.  On the CPU the parts are
    concatenated for the plain version;
  * decode is the *absorbed* formulation: ``w_uk`` is folded into the query,
    which scores against the latent cache directly, so the cache and a
    step's reads are O(kv_lora_rank + rope_dim) per token instead of
    O(heads * head_dim).  It is plain PyTorch, as the reference's is plain
    jnp (no Pallas kernel lies there).

Cache layout: ``{"ckv": (B, S, kv_lora_rank), "k_rope": (B, S, rope_dim)}``,
written in place.  A prefill given a cache writes the prompt's latents in
the same pass (the reference runs a cache-less forward, then recomputes
each layer's latents from the same normed input: the same values).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import NEG_INF, _proj_in, _proj_out
from repro_torch.models.common import ParamSpec


def spec(cfg: ModelConfig) -> common.SpecTree:
    d, h = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "w_dq": ParamSpec((d, ql), ("embed", "latent")),
        "q_norm": ParamSpec((ql,), ("latent",), init="ones"),
        "w_uq": ParamSpec((ql, h, nope + rope), (None, "heads", None)),
        "w_dc": ParamSpec((d, kvl), ("embed", "latent")),
        "w_dr": ParamSpec((d, rope), ("embed", None)),
        "kv_norm": ParamSpec((kvl,), ("latent",), init="ones"),
        "w_uk": ParamSpec((kvl, h, nope), (None, "heads", None)),
        "w_uv": ParamSpec((kvl, h, vd), (None, "heads", None)),
        "wo": ParamSpec((h, vd, d), ("heads", None, "embed")),
    }


def with_kernel_heads(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with deepseek-v3's own MLA head dims, nope 128 + rope 64 and
    v 128: the flash kernel's one pair with Dv != D, (D, Dv) = (192, 128)
    (``kernels.flash_attention.HEAD_DIMS``).  A reduced config (qk 48, v
    32) runs on the card only so; on the CPU any head dims run."""
    return dataclasses.replace(cfg, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


def _q_proj(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    ql = torch.matmul(x, params["w_dq"].to(x.dtype))
    ql = common.rmsnorm(ql, params["q_norm"], cfg.norm_eps)
    q = _proj_in(ql, params["w_uq"])  # (B, S, H, nope + rope)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = common.apply_rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(c (B, S, kv_lora), k_rope (B, S, rope)): the latent and the shared
    rope channel, given a singleton head dim for ``apply_rope``."""
    c = torch.matmul(x, params["w_dc"].to(x.dtype))
    k_rope = torch.matmul(x, params["w_dr"].to(x.dtype))
    c = common.rmsnorm(c, params["kv_norm"], cfg.norm_eps)
    k_rope = common.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one layer's latent cache."""
    return {"ckv": ((batch, max_len, cfg.kv_lora_rank), dtype),
            "k_rope": ((batch, max_len, cfg.qk_rope_head_dim), dtype)}


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_len, dtype).items()}


def _decompressed(params, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k_nope, v) of the decompressed path: K's nope part and V per head
    from the latent, each (B, S, H, .)."""
    return _proj_in(c, params["w_uk"]), _proj_in(c, params["w_uv"])


def apply(
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
    """MLA self-attention (causal).  Without a cache: the decompressed flash
    path (training, the reference's prefill forward).  With a cache, its
    rows ``cur_len .. cur_len + Sq`` take the latents in place; then one
    token (Sq == 1) runs the absorbed decode against the whole cache, with
    positions past ``cur_len`` masked, and a prompt (Sq > 1) the
    decompressed flash path over its own tokens.  Returns (out, cache).

    The scale is ``(nope + rope)^-1/2``, the flash kernel's own D^-1/2 of
    the concatenated q (the reference's pre-scale factor is 1).
    """
    sq, dt = x.shape[1], x.dtype
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    q_nope, q_rope = _q_proj(params, x, cfg, positions)
    c, k_rope = _kv_latent(params, x, cfg, positions)
    if cache is not None:
        if cur_len is None:
            raise ValueError("mla.apply with a cache needs cur_len")
        start = int(cur_len)
        cache["ckv"][:, start:start + sq] = c.to(cache["ckv"].dtype)
        cache["k_rope"][:, start:start + sq] = k_rope.to(cache["k_rope"].dtype)
    if cache is None or sq > 1:
        k_nope, v = _decompressed(params, c)
        out = fa.flash_attention_split(q_nope, q_rope, k_nope, k_rope[:, :, None], v, causal=True,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
        return _proj_out(out, params["wo"]), cache
    # absorbed decode: fold w_uk into the query, score against the latents
    ckv, rope_c = cache["ckv"].to(dt), cache["k_rope"].to(dt)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
    s_lat = torch.einsum("bhr,bsr->bhs", q_abs[:, 0], ckv)
    s_rope = torch.einsum("bhk,bsk->bhs", q_rope[:, 0], rope_c)
    logits = (s_lat + s_rope).to(torch.float32) * scale
    valid = torch.arange(ckv.shape[1], device=x.device)[None, None, :] < start + 1
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bhs,bsr->bhr", probs, ckv)
    out = torch.einsum("bhr,rhk->bhk", ctx, params["w_uv"].to(dt))[:, None]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache


def mla_ref(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Full-materialization oracle (decompressed path, naive softmax)."""
    from repro_torch.kernels import ref as kref

    q_nope, q_rope = _q_proj(params, x, cfg, positions)
    c, k_rope = _kv_latent(params, x, cfg, positions)
    k_nope, v = _decompressed(params, c)
    q, k = fa._joined(q_nope, q_rope, k_nope, k_rope[:, :, None])  # the oracle concatenates
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    out = kref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
