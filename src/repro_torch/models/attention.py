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
pinned to ``"bthd"``, the reference's sites; :func:`flash_attention` (and
MLA's :func:`flash_attention_split`) then runs the same kernel, forward
and backward, on each rank's own heads through ``local_map``
(:func:`_local_heads`).  A cache placed by the reference's state rules
(``distributed.sharding.distribute_state``) takes each rank's batch rows
and kv heads in its own local shard (:func:`write_cache`), and decode
reads that shard alone (:func:`_decode`).
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
        return _local_heads(fa.flash_attention, (q,), (k, v), **kw)
    return fa.flash_attention(q, k, v, **kw)


def _head_layout(q: torch.Tensor, kvs) -> tuple[tuple, list[tuple[tuple, tuple, object]]]:
    """The ``"bthd"`` placements of DTensor ``q`` and, for each of ``kvs``
    (key-side parts, each with its own head count dividing q's), its
    placements, its gradient's and the local heads ``pick`` that serve this
    rank's query heads: None where the part's heads shard with q's, else a
    (start, count) slice where each picked head serves the same number of
    this rank's query heads in order, else one index per local query head
    (G = 1).  Where a part stays whole over the model axes and q does not,
    its gradient is a partial sum over those axes."""
    from torch.distributed.tensor import Partial, Shard

    mesh = q.device_mesh
    q_pl = act_sharding.placements("bthd", tuple(q.shape))
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    hq = q.shape[2]
    out = []
    for t in kvs:
        pl = act_sharding.placements("bthd", tuple(t.shape))
        grad_pl, pick = pl, None
        if head_dims and pl[head_dims[0]] != Shard(2):
            r, shards = sharding.mesh_rank(mesh, head_dims)
            hl, g = hq // shards, hq // t.shape[2]
            idx = [(r * hl + j) // g for j in range(hl)]  # the part's head of each local query head
            heads = sorted(set(idx))
            per = hl // len(heads)
            pick = (heads[0], len(heads)) if idx == [h for h in heads for _ in range(per)] else idx
            grad_pl = tuple(Partial() if i in head_dims else p for i, p in enumerate(pl))
        out.append((pl, grad_pl, pick))
    return q_pl, out


def _picked(t: torch.Tensor, pick) -> torch.Tensor:
    """The heads ``pick`` (see :func:`_head_layout`) of a local (B, S, H, D)."""
    if isinstance(pick, tuple):
        return t.narrow(2, *pick).contiguous()
    if pick is not None:
        return t.index_select(2, torch.tensor(pick, device=t.device))
    return t


def _local_heads(fn, qs, kvs, **kw) -> torch.Tensor:
    """``fn(*qs, *kvs, **kw)`` on each rank's heads of DTensors: the query
    parts ``qs`` (q, or MLA's q_nope and q_rope) at ``"bthd"`` (batch over
    the data axes, heads over the model axes where they divide), the
    key-side parts ``kvs`` (k and v, or MLA's k_nope, its one k_rope channel
    and v) each at its own ``"bthd"`` placements, through ``local_map``:
    the flash kernel and its backward, never another attention.

    Where a key-side part's heads divide the model axes they shard with
    q's, and a rank's query groups meet their own kv heads.  Where they do
    not (MQA, fewer kv heads than model shards, MLA's shared k_rope) the
    part stays whole over the model axes and each rank takes the heads of
    its own query heads (:func:`_head_layout`); its gradient is then a
    partial sum over the model axes (``in_grad_placements``), which the
    redistribution of the part adds up.
    """
    from torch.distributed.tensor.experimental import local_map

    q_pl, layout = _head_layout(qs[0], kvs)
    nq = len(qs)

    def local(*parts):
        picked = [_picked(t, pick) for t, (_, _, pick) in zip(parts[nq:], layout)]
        return fn(*parts[:nq], *picked, **kw)

    f = local_map(local, out_placements=list(q_pl),
                  in_placements=(q_pl,) * nq + tuple(pl for pl, _, _ in layout),
                  in_grad_placements=(q_pl,) * nq + tuple(g for _, g, _ in layout),
                  device_mesh=qs[0].device_mesh, redistribute_inputs=True)
    return f(*qs, *kvs)


def flash_attention_split(q_nope, q_rope, k_nope, k_rope, v, **kw) -> torch.Tensor:
    """MLA's attention from its parts
    (:func:`kernels.flash_attention.flash_attention_split`); DTensors (a
    mesh's activations) go through :func:`_local_heads`, k_rope's one
    channel whole over the model axes."""
    if act_sharding.active()[0] is not None and sharding.is_dtensor(q_nope):
        return _local_heads(fa.flash_attention_split, (q_nope, q_rope), (k_nope, k_rope, v), **kw)
    return fa.flash_attention_split(q_nope, q_rope, k_nope, k_rope, v, **kw)


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + Sq] = new`` in place, in the cache's dtype.
    A DTensor cache takes its own rows in each rank's local shard: ``new``
    at the cache's placements (batch rows over the data axes, kv heads over
    the model axes where they divide, as both sets of rules place them),
    written locally; no cache is gathered.

    Raises:
        NotImplementedError: a cache sharded along its sequence (the
            reference's ``kv_seq_shard``): writing and decoding there need a
            combine across ranks (flash-decoding), ROADMAP Queue 1.
    """
    sq = new.shape[1]
    if not sharding.is_dtensor(cache):
        cache[:, start:start + sq] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Shard

    if Shard(1) in tuple(cache.placements):
        raise NotImplementedError("a cache sharded along its sequence (kv_seq_shard) needs a "
                                  "combine across ranks to decode (flash-decoding): ROADMAP "
                                  "Queue 1")
    if tuple(new.placements) != tuple(cache.placements):
        new = new.redistribute(cache.device_mesh, cache.placements)
    cache.to_local()[:, start:start + sq] = new.to_local().to(cache.dtype)


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


def _decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cur_len: int) -> torch.Tensor:
    """:func:`decode_attention`; on DTensors each rank's query heads against
    the kv heads of its own local cache shard (``local_map``, the heads
    picked as :func:`_local_heads` picks them), nothing gathered."""
    if not sharding.is_dtensor(q):
        return decode_attention(q, k_cache, v_cache, cur_len)
    from torch.distributed.tensor.experimental import local_map

    q_pl, layout = _head_layout(q, (k_cache, v_cache))
    (kv_pl, _, pick), _ = layout

    def local(ql, kl, vl):
        return decode_attention(ql, _picked(kl, pick), _picked(vl, pick), cur_len)

    f = local_map(local, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                  device_mesh=q.device_mesh, redistribute_inputs=True)
    return f(q, k_cache, v_cache)


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
        write_cache(cache["k"], k, start)
        write_cache(cache["v"], v, start)
        if sq == 1:
            out = _decode(q, cache["k"], cache["v"], start + 1)
        else:  # prefill into cache: attend over the fresh prefix only
            out = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _proj_out(out, params["wo"]), cache


def attention_ref(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Full-materialization oracle for tests."""
    from repro_torch.kernels import ref as kref

    q, k, v = _project_qkv(params, x, cfg, positions)
    out = kref.flash_attention_ref(q, k, v, causal=True)
    return _proj_out(out, params["wo"])
