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

On a mesh (``distributed.act_sharding.use_rules``) q, k and v are DTensors
pinned to ``"bthd"``, the reference's sites; :func:`flash_attention` then
runs the same kernel, forward and backward, on each rank's own heads
through ``local_map`` (:func:`_local_heads`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding, sharding
from repro_torch.distributed.act_sharding import shard
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
    q = shard(_proj_in(x, params["wq"]), "bthd")
    k = shard(_proj_in(x, params["wk"]), "bthd")
    v = shard(_proj_in(x, params["wv"]), "bthd")
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
    differentiable (``kernels.flash_attention.FlashAttention``).  DTensors
    (a mesh's activations) go through :func:`_local_heads`.
    """
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    if act_sharding.active()[0] is not None and sharding.is_dtensor(q):
        return _local_heads(q, k, v, **kw)
    return fa.flash_attention(q, k, v, **kw)


def _local_heads(q, k, v, **kw) -> torch.Tensor:
    """:func:`kernels.flash_attention.flash_attention` on each rank's heads
    of DTensors q, k, v (``"bthd"``: batch over the data axes, heads over
    the model axes where they divide), through ``local_map``: the kernel
    and its backward, never another attention.

    Where the kv heads divide the model axes they shard with q's, and a
    rank's query groups meet their own kv heads.  Where they do not (MQA,
    or fewer kv heads than model shards) k and v stay replicated and each
    rank takes the kv heads of its own query heads: a slice where each of
    them serves the same number of its query heads in order, else one kv
    head per query head (G = 1).  Their gradients are then partial sums
    over the model axes (``in_grad_placements``), which the redistribution
    of k and v adds up.
    """
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl = act_sharding.placements("bthd", tuple(q.shape))
    kv_pl = act_sharding.placements("bthd", tuple(k.shape))
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    hq, hkv = q.shape[2], k.shape[2]
    kv_grad_pl = kv_pl
    pick = None  # the kv heads of this rank's query heads, when k and v are whole
    if head_dims and kv_pl[head_dims[0]] != Shard(2):
        r, shards = sharding.mesh_rank(mesh, head_dims)
        hl, g = hq // shards, hq // hkv
        idx = [(r * hl + j) // g for j in range(hl)]  # the kv head of each local query head
        heads = sorted(set(idx))
        per = hl // len(heads)
        pick = (heads[0], len(heads)) if idx == [h for h in heads for _ in range(per)] else idx
        kv_grad_pl = tuple(Partial() if i in head_dims else p for i, p in enumerate(kv_pl))

    def local(ql, kl, vl):
        if isinstance(pick, tuple):
            kl = kl.narrow(2, *pick).contiguous()
            vl = vl.narrow(2, *pick).contiguous()
        elif pick is not None:
            at = torch.tensor(pick, device=kl.device)
            kl, vl = kl.index_select(2, at), vl.index_select(2, at)
        return fa.flash_attention(ql, kl, vl, **kw)

    fn = local_map(local, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad_pl, kv_grad_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)


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
