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

On a mesh q, k_nope and v are pinned to ``"bthd"`` at the reference's
sites, the flash call runs on each rank's heads with k_rope's one channel
whole over the model axes (``attention.flash_attention_split``), the latent
stays whole over the model axes (the reference's rules keep ``latent``
replicated), the cache is written in each rank's local shard (batch rows
over the data axes) and the absorbed decode runs on each rank's heads
against that shard (:func:`_absorbed_heads`).  Latents split along their
sequence (the reference's ``kv_seq_shard``) take each rank's own rows, and
the absorbed decode combines each rank's partial softmax over them
(:func:`_absorbed_seq`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding, sharding
from repro_torch.distributed.act_sharding import shard
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, common
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
    # the latents stay whole over the model axes (the reference's rules keep
    # 'latent' replicated): pinned, as DTensor's propagation may split them
    ql = shard(torch.matmul(x, params["w_dq"].to(x.dtype)), "btd")
    ql = common.rmsnorm(ql, params["q_norm"], cfg.norm_eps)
    q = shard(_proj_in(ql, params["w_uq"]), "bthd")  # (B, S, H, nope + rope)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = common.apply_rope(q[..., cfg.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(c (B, S, kv_lora), k_rope (B, S, rope)): the latent and the shared
    rope channel, given a singleton head dim for ``apply_rope``."""
    c = shard(torch.matmul(x, params["w_dc"].to(x.dtype)), "btd")
    k_rope = shard(torch.matmul(x, params["w_dr"].to(x.dtype)), "btd")
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
    return shard(_proj_in(c, params["w_uk"]), "bthd"), shard(_proj_in(c, params["w_uv"]), "bthd")


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
    sq = x.shape[1]
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    q_nope, q_rope = _q_proj(params, x, cfg, positions)
    c, k_rope = _kv_latent(params, x, cfg, positions)
    if cache is not None:
        if cur_len is None:
            raise ValueError("mla.apply with a cache needs cur_len")
        start = int(cur_len)
        attention.write_cache(cache["ckv"], c, start)
        attention.write_cache(cache["k_rope"], k_rope, start)
    if cache is None or sq > 1:
        k_nope, v = _decompressed(params, c)
        out = attention.flash_attention_split(q_nope, q_rope, k_nope, k_rope[:, :, None], v,
                                              causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return _proj_out(out, params["wo"]), cache
    weights = (params["w_uk"], params["w_uv"], params["wo"])
    if sharding.is_dtensor(q_nope) and attention._seq_dims(cache["ckv"]):
        return _absorbed_seq(weights, q_nope, q_rope, cache, start + 1, scale), cache
    if sharding.is_dtensor(q_nope):
        return _absorbed_heads(weights, q_nope, q_rope, cache, start + 1, scale), cache
    return _absorbed(*weights, q_nope, q_rope, cache["ckv"], cache["k_rope"], start + 1,
                     scale), cache


def _absorbed(w_uk, w_uv, wo, q_nope, q_rope, ckv_cache, rope_cache, cur_len: int,
              scale: float) -> torch.Tensor:
    """The absorbed decode of one token: w_uk folded into the query, scored
    against the latents, positions from ``cur_len`` on masked, then w_uv
    and wo; (B, 1, d)."""
    dt = q_nope.dtype
    ckv, rope_c = ckv_cache.to(dt), rope_cache.to(dt)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_uk.to(dt))
    s_lat = torch.einsum("bhr,bsr->bhs", q_abs[:, 0], ckv)
    s_rope = torch.einsum("bhk,bsk->bhs", q_rope[:, 0], rope_c)
    logits = (s_lat + s_rope).to(torch.float32) * scale
    valid = torch.arange(ckv.shape[1], device=ckv.device)[None, None, :] < cur_len
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bhs,bsr->bhr", probs, ckv)
    out = torch.einsum("bhr,rhk->bhk", ctx, w_uv.to(dt))[:, None]
    return torch.einsum("bshk,hkd->bsd", out, wo.to(dt))


def _absorbed_heads(weights, q_nope, q_rope, cache, cur_len: int, scale: float) -> torch.Tensor:
    """:func:`_absorbed` on a mesh through ``local_map``: each rank's query
    heads (``"bthd"``) and the same heads of w_uk, w_uv and wo (gathered
    over the data axes, where wo's d_model lies), against its own local
    shard of the latent cache (batch rows over the data axes, the latent
    whole over the model axes, as the reference's state rules place it).
    The output is each rank's heads' share of (B, 1, d): a partial sum over
    the model axes that split the heads, which the residual's ``"btd"``
    placement adds up."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q_nope.device_mesh
    q_pl = act_sharding.placements("bthd", tuple(q_nope.shape))
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    w_pl = tuple(Shard(1) if i in heads else Replicate() for i in range(mesh.ndim))
    wo_pl = tuple(Shard(0) if i in heads else Replicate() for i in range(mesh.ndim))
    out_pl = [Partial() if i in heads else p for i, p in enumerate(q_pl)]
    ckv, rope_c = cache["ckv"], cache["k_rope"]

    def local(w_uk, w_uv, wo, qn, qr, c, r):
        return _absorbed(w_uk, w_uv, wo, qn, qr, c, r, cur_len, scale)

    f = local_map(local, out_placements=out_pl,
                  in_placements=(w_pl, w_pl, wo_pl, q_pl, q_pl, tuple(ckv.placements),
                                 tuple(rope_c.placements)),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(*weights, q_nope, q_rope, ckv, rope_c)


def _absorbed_seq(weights, q_nope, q_rope, cache, cur_len: int, scale: float) -> torch.Tensor:
    """:func:`_absorbed` on latents split along their sequence over the
    model axes (``kv_seq_shard``): each rank folds w_uk into its own query
    heads, the folded queries and q_rope gathered whole over the model
    axes; every head scores the rank's own latents (global positions from
    its offset), its partial softmax (m, l and the latent context of its
    own softmax, :func:`_absorbed`'s ops on the rank's rows) gathered over
    the sequence's mesh dims and combined in rank order
    (``attention.combine_partials``: one part gives :func:`_absorbed`'s
    bits); then each rank's heads of
    the context through its w_uv and wo, a partial sum over the model axes
    that split the heads (as in :func:`_absorbed_heads`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q_nope.device_mesh
    ckv, rope_c = cache["ckv"], cache["k_rope"]
    seq = attention._seq_dims(ckv)
    batch = [i for i, p in enumerate(ckv.placements) if p == Shard(0)]
    q_pl = act_sharding.placements("bthd", tuple(q_nope.shape))
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    w_pl = tuple(Shard(1) if i in heads else Replicate() for i in range(mesh.ndim))
    wo_pl = tuple(Shard(0) if i in heads else Replicate() for i in range(mesh.ndim))
    rows = tuple(Shard(0) if i in batch else Replicate() for i in range(mesh.ndim))
    w_uk, w_uv, wo = weights
    dt = q_nope.dtype

    def fold(qn, wk):
        return torch.einsum("bshk,rhk->bshr", qn, wk.to(dt))

    q_abs = local_map(fold, out_placements=list(q_pl), in_placements=(q_pl, w_pl),
                      device_mesh=mesh, redistribute_inputs=True)(q_nope, w_uk)
    q_abs = q_abs.redistribute(mesh, rows).to_local()[:, 0]
    q_r = q_rope.redistribute(mesh, rows).to_local()[:, 0]
    c_l, r_l = ckv.to_local().to(dt), rope_c.to_local().to(dt)
    s_lat = torch.einsum("bhr,bsr->bhs", q_abs, c_l)
    s_rope = torch.einsum("bhk,bsk->bhs", q_r, r_l)
    offset = sharding.mesh_rank(mesh, seq)[0] * c_l.shape[1]
    valid = offset + torch.arange(c_l.shape[1], device=c_l.device)[None, None, :] < cur_len
    m, l, probs = attention.softmax_partial((s_lat + s_rope).to(torch.float32) * scale, valid)
    o = torch.einsum("bhs,bsr->bhr", probs.to(dt), c_l)  # as _absorbed: probs in dt
    ctx = attention.combine_over_ranks((m, l, o), mesh, seq, batch)
    ctx = DTensor.from_local(ctx.to(dt), mesh, rows, run_check=False)
    ctx_pl = tuple(Shard(1) if i in heads else p for i, p in enumerate(rows))
    out_pl = [Partial() if i in heads else p for i, p in enumerate(q_pl)]

    def unfold(c, wv, w_o):
        out = torch.einsum("bhr,rhk->bhk", c, wv.to(dt))[:, None]
        return torch.einsum("bshk,hkd->bsd", out, w_o.to(dt))

    return local_map(unfold, out_placements=out_pl, in_placements=(ctx_pl, w_pl, wo_pl),
                     device_mesh=mesh, redistribute_inputs=True)(ctx, w_uv, wo)


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
