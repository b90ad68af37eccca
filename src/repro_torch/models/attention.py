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
reads that shard alone (:func:`_decode`).  A cache placed along its
sequence (the reference's ``kv_seq_shard``: kv heads that do not divide
the model axes) takes each rank's own rows; decode then runs
flash-decoding: each rank's partial softmax over its own keys
(:func:`decode_partial`), gathered over the ranks and combined in rank
order (:func:`combine_partials`).
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


def _whole_singleton_heads(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` with a head dim of size 1 whole over the mesh, on a DTensor
    where a mesh dim of size 1 shards it (MQA's one kv head on a (1, 1)
    mesh): a view cannot flatten a sharded singleton dim, and the layout
    moves no data."""
    if w.shape[dim] != 1 or not sharding.is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    if Shard(dim) not in tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, [Replicate() if p == Shard(dim) else p
                                          for p in w.placements])


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened (h, k)."""
    d, h, k = w.shape
    w = _whole_singleton_heads(w, 1)
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


def layer_cache(cache: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked cache (L, B, S, H, D), a view that writes
    through: a DTensor's layer is a DTensor on its local shard's layer, at
    the stacked placements without the layer dim."""
    if not sharding.is_dtensor(cache):
        return cache[i]
    from torch.distributed.tensor import DTensor, Shard

    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in cache.placements]
    shape = tuple(cache.shape[1:])
    return DTensor.from_local(cache.to_local()[i], cache.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _seq_dims(cache: torch.Tensor) -> list[int]:
    """The mesh dims that split a DTensor cache along its sequence (dim 1)."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(cache.placements) if p == Shard(1)]


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + Sq] = new`` in place, in the cache's dtype.
    A DTensor cache takes its own rows in each rank's local shard: ``new``
    at the cache's placements (batch rows over the data axes, kv heads over
    the model axes where they divide, as both sets of rules place them),
    written locally; no cache is gathered.  A cache split along its
    sequence (``kv_seq_shard``) takes, on each rank, the rows of
    ``[start, start + Sq)`` that fall in its own sequence range, from
    ``new`` whole along the sequence."""
    sq = new.shape[1]
    if not sharding.is_dtensor(cache):
        cache[:, start:start + sq] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    seq = _seq_dims(cache)
    want = tuple(Replicate() if i in seq else p for i, p in enumerate(cache.placements))
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    local, rows = cache.to_local(), new.to_local()
    lo = sharding.mesh_rank(mesh, seq)[0] * local.shape[1]
    a, b = max(start, lo), min(start + sq, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = rows[:, a - start:b - start].to(cache.dtype)


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


DecodePartial = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def softmax_partial(logits: torch.Tensor,
                    valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One part's softmax over its keys (the last dim) in f32: (the max m of
    the valid logits, the sum l of their exponentials ``exp(logit - m)``,
    the part's own softmax, invalid keys masked with ``NEG_INF`` as
    :func:`decode_attention` masks them).  A part with no valid key has a
    finite max (``NEG_INF``) and l = 0: its weight in
    :func:`combine_partials` is 0."""
    logits = torch.where(valid, logits.to(torch.float32), NEG_INF)
    m = logits.amax(dim=-1)
    l = torch.where(valid, torch.exp(logits - m[..., None]), 0.0).sum(dim=-1)
    return m, l, torch.softmax(logits, dim=-1)


def decode_partial(q: torch.Tensor, k_part: torch.Tensor, v_part: torch.Tensor, cur_len: int,
                   offset: int = 0) -> DecodePartial:
    """:func:`decode_attention` over one part of the cache, the keys at
    global positions ``offset .. offset + S_part`` (those at or past
    ``cur_len`` masked), for :func:`combine_partials`.  q (B,1,Hq,D);
    parts (B,S_part,Hkv,D).  Returns f32 (m (B,Hq): the max logit, l
    (B,Hq): the sum of exponentials, o (B,Hq,D): the part's output, its
    own softmax over its keys times v: the whole cache's
    ``decode_attention`` when the part is the whole cache)."""
    b, _, hq, d = q.shape
    _, s, hkv, dv = v_part.shape
    g = hq // hkv
    qf = q.reshape(b, hkv, g, d).to(torch.float32) * d**-0.5
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k_part.to(torch.float32))
    valid = offset + torch.arange(s, device=q.device)[None, None, None, :] < cur_len
    m, l, probs = softmax_partial(logits, valid)
    o = torch.einsum("bhgk,bkhd->bhgd", probs, v_part.to(torch.float32))
    return m.reshape(b, hq), l.reshape(b, hq), o.reshape(b, hq, dv)


def combine_partials(parts: list[DecodePartial]) -> torch.Tensor:
    """The attention output of one query's keys from the partials
    ``[(m, l, o), ...]`` of its parts (:func:`decode_partial`, f32),
    combined in list order: each part's weight ``l exp(m - M)`` (M the
    largest max) over the weights' sum, added left to right, times its
    output.  One part's weight is exactly 1, so one part gives its output's
    bits.  A plain function: the same bits for the same list, whatever
    produced it.  Returns o's shape in f32."""
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    weights = [l * torch.exp(m - m_all) for m, l, _ in parts]
    total = weights[0]
    for w in weights[1:]:
        total = total + w
    out = None
    for w, (_, _, o) in zip(weights, parts):
        term = (w / total)[..., None] * o
        out = term if out is None else out + term
    return out


def combine_over_ranks(part: DecodePartial, mesh, dims: list[int],
                       batch_dims: list[int]) -> torch.Tensor:
    """:func:`combine_partials` of every rank's partial ``part`` (its batch
    rows first) over the ranks of the mesh dims ``dims``: the partials
    gathered in rank order (one collective), then combined; the same
    bits on each of those ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    m, l, o = part
    packed = torch.cat([m[..., None], l[..., None], o.to(torch.float32)], dim=-1)[None]
    pl = [Shard(0) if i in dims else Shard(1) if i in batch_dims else Replicate()
          for i in range(mesh.ndim)]
    whole = [Replicate() if i in dims else p for i, p in enumerate(pl)]
    parts = DTensor.from_local(packed, mesh, pl, run_check=False).redistribute(mesh, whole)
    return combine_partials([(x[..., 0], x[..., 1], x[..., 2:])
                             for x in parts.to_local().unbind(0)])


def _decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cur_len: int) -> torch.Tensor:
    """:func:`decode_attention`; on DTensors each rank's query heads against
    the kv heads of its own local cache shard (``local_map``, the heads
    picked as :func:`_local_heads` picks them), nothing gathered; on a
    cache split along its sequence, :func:`_decode_seq`."""
    if not sharding.is_dtensor(q):
        return decode_attention(q, k_cache, v_cache, cur_len)
    if _seq_dims(k_cache):
        return _decode_seq(q, k_cache, v_cache, cur_len)
    from torch.distributed.tensor.experimental import local_map

    q_pl, layout = _head_layout(q, (k_cache, v_cache))
    (kv_pl, _, pick), _ = layout

    def local(ql, kl, vl):
        return decode_attention(ql, _picked(kl, pick), _picked(vl, pick), cur_len)

    f = local_map(local, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                  device_mesh=q.device_mesh, redistribute_inputs=True)
    return f(q, k_cache, v_cache)


def _decode_seq(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                cur_len: int) -> torch.Tensor:
    """Decode on a cache split along its sequence over the model axes
    (flash-decoding): every query head on each rank (q gathered over the
    sequence's mesh dims) against the rank's own keys, its partial
    (:func:`decode_partial`, global positions from the rank's offset)
    gathered over those dims and combined in rank order
    (:func:`combine_partials`): the output whole over them, the same on
    each rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    seq = _seq_dims(k_cache)
    batch = [i for i, p in enumerate(k_cache.placements) if p == Shard(0)]
    q_pl = tuple(Shard(0) if i in batch else Replicate() for i in range(mesh.ndim))
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    offset = sharding.mesh_rank(mesh, seq)[0] * kl.shape[1]
    out = combine_over_ranks(decode_partial(ql, kl, vl, cur_len, offset), mesh, seq, batch)
    return DTensor.from_local(out[:, None].to(q.dtype), mesh, q_pl, run_check=False)


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
