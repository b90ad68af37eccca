"""GQA/MQA attention with flash prefill and KV-cache decode (port of
``repro.models.attention``).

Prefill attention goes through :func:`flash_attention`, whose tensor decides
the path: on the card the hand-written kernel
(``repro_torch/csrc/flash_attention.cu``, the counterpart of the Pallas
``flash_attention_tpu`` that the reference selects on its accelerator), on
the CPU the chunked online-softmax plain version; in training (q, k or v
requiring grad) the same call goes through the kernel's autograd function,
whose backward is the hand-written backward kernel on the card.  Decode
is one query against the cache in plain PyTorch, as in the reference (no
Pallas kernel there either).  The KV cache is written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

NEG_INF = fa.NEG_INF


def spec(cfg: ModelConfig) -> common.SpecTree:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: common.SpecTree = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        s["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return s


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened (h, k)."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(
    params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj_in(x, params["wq"])
    k = _proj_in(x, params["wk"])
    v = _proj_in(x, params["wv"])
    if cfg.qk_norm:
        q = common.rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = common.rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _proj_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul over the flattened (h, k)."""
    h, k, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.to(out.dtype).reshape(h * k, d))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention. q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D).

    CUDA tensors run the kernel (one launch); CPU tensors run the chunked
    plain version with ``q_chunk`` / ``kv_chunk``.  Under grad the call is
    differentiable (``kernels.flash_attention.FlashAttention``).
    """
    return fa.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                              q_offset=q_offset)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len: int
) -> torch.Tensor:
    """Single-step decode: q (B,1,Hq,D) against cache (B,S,Hkv,D); cache
    positions >= ``cur_len`` are masked."""
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qf = q.reshape(b, hkv, g, d).to(torch.float32) * d**-0.5
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(torch.float32))
    valid = torch.arange(s, device=q.device)[None, None, None, :] < cur_len
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(q.dtype)


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: dict[str, torch.Tensor] | None = None,
    cur_len: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Self-attention. If ``cache`` is given, runs one decode step (Sq==1) or
    prefill-writing-cache (Sq>1); else full-sequence flash attention.

    The cache's rows ``cur_len .. cur_len + Sq`` are written in place (the
    reference's ``dynamic_update_slice`` returns a new array); the returned
    cache is the same dict.
    """
    sq = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, positions)

    if cache is None:
        out = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        if cur_len is None:
            raise ValueError("attention.apply with a cache needs cur_len")
        start = int(cur_len)
        cache["k"][:, start:start + sq] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + sq] = v.to(cache["v"].dtype)
        if sq == 1:
            out = decode_attention(q, cache["k"], cache["v"], start + 1)
        else:  # prefill into cache: attend over the fresh prefix only
            out = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _proj_out(out, params["wo"]), cache


def attention_ref(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Full-materialization oracle for tests."""
    from repro_torch.kernels import ref as kref

    q, k, v = _project_qkv(params, x, cfg, positions)
    out = kref.flash_attention_ref(q, k, v, causal=True)
    return _proj_out(out, params["wo"])
