"""Mixture-of-Experts FFN with a capacity dispatch, shared experts, and both
softmax (Switch/granite) and sigmoid + aux-free (DeepSeek-V3) routing (port
of ``repro.models.moe``).

Semantics are the reference's: each batch row is a group; its tokens route
to ``experts_per_token`` experts; every expert holds ``capacity`` slots per
group, filled in token order (a stable sort of the assignments by expert),
and assignments past the last slot are dropped, as in GShard/Switch.  The
expert products run over every slot, ``(E, G * C, d)``, empty slots on zero
rows.  The reference's ``lax.scan`` over token chunks is a Python loop.

On a mesh (:func:`_moe_chunk_mesh`) groups shard over the data axes and
experts over the model axes; the reference's three ``act_sharding.shard``
sites (``"gecd"`` on the dispatched and the products' buffers, ``"btd"`` on
the combined output) pin each rank's share, and the combine's partial
sums over the model axes are reduced there.  On a (1, 1) mesh every bit
equals the one-card layer's; where the experts split over the model axes
a token's output adds the ranks' partial sums, which rounds otherwise
than the one-card left-to-right sum over its slots (f32: within 1e-4 of
the reference's, ``tests/test_torch_mesh_families.py``).  On one card (a
plain tensor) those calls return their argument.

Dispatch and combine are gathers, in both directions.  The reference
gathers tokens into slots (``take``) and scatter-adds the slots' weighted
outputs back into tokens; on the card a scatter-add (and autograd's
backward of an indexed gather) sums with atomics, in an order that changes
from run to run, so a train step would not give the same bits twice.  Here
:func:`_slot_maps` builds both maps, slot -> token and token -> its k slots,
and :class:`_GatherRows` gathers through one map with a backward that
gathers through the other.  Each token's slots are summed in ascending
expert id, left to right from a zero row, in the tensor's dtype: the order
in which the reference's scatter-add (XLA's, on the CPU) applies the
slots, which are laid out expert by expert.  Dropped choices and empty
slots point at a zero row appended to the source, as the reference's
sentinel index T reads zeros (``mode="fill"``) and writes to a sink row.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding
from repro_torch.distributed.act_sharding import shard
from repro_torch.distributed.sharding import is_dtensor, mesh_rank
from repro_torch.models import common, ffn
from repro_torch.models.common import ParamSpec


def spec(cfg: ModelConfig) -> common.SpecTree:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s: common.SpecTree = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_down": ParamSpec((e, f, d), ("experts", None, "embed")),
    }
    if cfg.router_aux_free:
        # DeepSeek aux-loss-free routing bias: selects experts, gets no gradient
        s["router_bias"] = ParamSpec((e,), ("experts",), init="zeros")
    if cfg.n_shared_experts:
        s["shared"] = ffn.spec(cfg, d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return s


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens_per_group * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(c, 1)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last dim, largest first; of
    equal entries the lower index first, as ``lax.top_k`` orders them
    (``torch.topk`` leaves ties in no stated order).  The order of the k
    choices decides each slot's ``kslot`` and so its combine weight."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _route(params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, T, d) -> (weights (G,T,k) in x's dtype, idx (G,T,k), aux scalar f32).

    The router runs in f32 whatever the model's dtype, as the reference's
    does, so bf16 models route alike on the card and the CPU.  The gathers
    of the chosen probabilities differentiate through a scatter-add whose
    destinations each receive one term (a token's k experts are distinct),
    so their gradient has no order to vary.
    """
    w, idx, probs, counts = _route_parts(params, x, cfg)
    return w, idx, _balance_loss(probs, counts, cfg, x.device)


def _route_parts(params, x: torch.Tensor, cfg: ModelConfig):
    """:func:`_route` up to its balance loss: (w, idx, probs, counts), the
    last two (G, T, E) in f32 under softmax routing (the router's
    probabilities, each token's choices one-hot over the experts) and None
    under aux-free routing."""
    logits = torch.matmul(x.to(torch.float32), params["router"].to(torch.float32))
    k = cfg.experts_per_token
    if cfg.router_aux_free:
        scores = torch.sigmoid(logits)
        sel = scores + params["router_bias"].detach().to(torch.float32)
        idx = _top_k(sel, k)
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
        return w.to(x.dtype), idx, None, None
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(probs, k)
    top = torch.gather(probs, -1, idx)
    w = top / torch.clamp_min(torch.sum(top, dim=-1, keepdim=True), 1e-9)
    # one-hot by comparison: F.one_hot checks its range on the host
    one_hot = (idx[..., None] == torch.arange(cfg.n_experts, device=idx.device)).to(torch.float32)
    return w.to(x.dtype), idx, probs, torch.sum(one_hot, dim=2)


def _balance_loss(probs, counts, cfg: ModelConfig, device) -> torch.Tensor:
    """Switch's load-balance loss, ``E * sum_e f_e * p_e`` with ``f_e`` the
    share of assignments and ``p_e`` the mean probability of expert e over
    every group and token; 0 under aux-free routing (``probs`` None)."""
    if probs is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    f_e = torch.mean(counts, dim=(0, 1)) / cfg.experts_per_token
    p_e = torch.mean(probs, dim=(0, 1))
    return cfg.n_experts * torch.sum(f_e * p_e)


def _dispatch_indices(
    idx: torch.Tensor, n_tokens: int, cfg: ModelConfig, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """idx: (G, T, k) expert ids -> (token_for_slot (G,E,C), kslot (G,E,C)).

    token_for_slot[g,e,c] is a token index in [0, T), or T where the slot is
    empty; kslot says which of the token's k choices routed there.  Slots
    fill in token order (a stable sort); an assignment whose position in
    its expert reaches ``cap`` is dropped: its write is sent to a sink
    element past the buffer, which is cut off (no write leaves the buffer).
    """
    g_dim, t_dim, k = idx.shape
    e_dim = cfg.n_experts
    dev = idx.device
    e_flat = idx.reshape(g_dim, t_dim * k)  # expert of each assignment, token-major
    order = torch.argsort(e_flat, dim=-1, stable=True)  # token order within each expert
    e_sorted = torch.gather(e_flat, 1, order)
    experts = torch.arange(e_dim, device=dev).expand(g_dim, e_dim).contiguous()
    starts = torch.searchsorted(e_sorted, experts)  # first position of each expert
    slot = torch.arange(t_dim * k, device=dev) - torch.gather(starts, 1, e_sorted)
    sink = e_dim * cap
    where = torch.where(slot < cap, e_sorted * cap + slot, sink)
    buf_tok = torch.full((g_dim, sink + 1), t_dim, dtype=torch.int64, device=dev)
    buf_k = torch.zeros((g_dim, sink + 1), dtype=torch.int64, device=dev)
    buf_tok.scatter_(1, where, order // k)  # assignment a = token * k + choice
    buf_k.scatter_(1, where, order % k)
    return (buf_tok[:, :sink].reshape(g_dim, e_dim, cap),
            buf_k[:, :sink].reshape(g_dim, e_dim, cap))


@dataclasses.dataclass(frozen=True)
class SlotMaps:
    """The two directions between token rows (``g * T + t``, G*T of them)
    and capacity rows (``(e * G + g) * C + c``, E*G*C of them: expert-major,
    so the expert products read ``(E, G * C, d)`` in place).

    ``token``: (E*G*C, 1) the token row of each capacity row, G*T where the
    slot is empty.  ``choices``: (G*T, k) the capacity rows of each token's
    k choices in ascending order (ascending expert id), E*G*C where the
    choice was dropped.  ``assignment``: (E*G*C, 1) the assignment
    ``(g * T + t) * k + j`` held by each capacity row, G*T*k where empty.
    ``assignment_row``: (G*T*k, 1) the capacity row of each assignment,
    E*G*C where dropped.  Every index equal to its source's row count reads
    the zero row :class:`_GatherRows` appends.
    """
    token: torch.Tensor
    choices: torch.Tensor
    assignment: torch.Tensor
    assignment_row: torch.Tensor


def _slot_maps(tok_slot: torch.Tensor, k_slot: torch.Tensor, n_tokens: int, k: int) -> SlotMaps:
    """Both maps from :func:`_dispatch_indices`' (G, E, C) buffers.  The
    token -> slot direction inverts the assignment map with a scatter whose
    targets are distinct, apart from a sink element that takes every empty
    slot and is cut off."""
    g_dim, e_dim, cap = tok_slot.shape
    dev = tok_slot.device
    filled = tok_slot < n_tokens
    row = torch.arange(g_dim, device=dev)[:, None, None] * n_tokens + tok_slot
    token = torch.where(filled, row, g_dim * n_tokens).transpose(0, 1).reshape(-1)
    assignment = torch.where(filled, row * k + k_slot, g_dim * n_tokens * k)
    assignment = assignment.transpose(0, 1).reshape(-1)
    n_rows = e_dim * g_dim * cap
    inverse = torch.full((g_dim * n_tokens * k + 1,), n_rows, dtype=torch.int64, device=dev)
    inverse.scatter_(0, assignment, torch.arange(n_rows, device=dev))
    assignment_row = inverse[:-1]
    choices = torch.sort(assignment_row.view(g_dim * n_tokens, k), dim=-1).values
    return SlotMaps(token[:, None], choices, assignment[:, None], assignment_row[:, None])


def gather_rows_plain(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j src_pad[index[i, j]]`` for j = 0, 1, ... left to
    right from a zero row, in src's dtype; ``src_pad`` is ``src`` with a
    zero row appended at index ``len(src)``.  One column is a plain take."""
    src_pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    if index.shape[1] == 1:
        return src_pad[index[:, 0]]
    out = src.new_zeros((index.shape[0],) + src.shape[1:])
    for j in range(index.shape[1]):
        out = out + src_pad[index[:, j]]
    return out


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows_plain` through ``index`` (M, m) into rows of
    ``src`` (N, ...), whose backward is the same gather of the incoming
    gradient through ``back`` (N, m'), the transpose map: ``back[n]`` lists
    every output row that reads source row n (M where there is none), in
    the order their terms are summed.  No atomics: the same bits every run,
    forward and backward."""

    @staticmethod
    def forward(ctx, src, index, back):
        ctx.save_for_backward(index, back)
        return gather_rows_plain(src, index)

    @staticmethod
    def backward(ctx, grad):
        _, back = ctx.saved_tensors
        return gather_rows_plain(grad.contiguous(), back), None, None


def _expert_ffn(params, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, N, d) -> (E, N, d), per-expert SwiGLU as batched products."""
    dt = xs.dtype
    gate = torch.bmm(xs, params["w_gate"].to(dt))
    up = torch.bmm(xs, params["w_up"].to(dt))
    return torch.bmm(torch.nn.functional.silu(gate) * up, params["w_down"].to(dt))


def _moe_chunk(params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (G, T, d) one token-chunk -> (out (G,T,d), aux)."""
    g_dim, t_dim, d = x.shape
    cap = capacity(t_dim, cfg)
    w, idx, aux = _route(params, x, cfg)
    tok_slot, k_slot = _dispatch_indices(idx, t_dim, cfg, cap)  # (G,E,C)
    maps = _slot_maps(tok_slot, k_slot, t_dim, cfg.experts_per_token)
    gather = _GatherRows.apply
    xs = gather(x.reshape(g_dim * t_dim, d), maps.token, maps.choices)  # (E*G*C, d)
    ys = _expert_ffn(params, xs.view(cfg.n_experts, g_dim * cap, d)).view(-1, d)
    # combine weight per slot, then each token's slots summed in expert order
    ws = gather(w.reshape(-1, 1), maps.assignment, maps.assignment_row)  # (E*G*C, 1)
    ys = ys * ws.to(ys.dtype)
    out = gather(ys, maps.choices, maps.token)
    return out.view(g_dim, t_dim, d), aux


def _local_maps(maps: SlotMaps, shard: int, e_local: int, rows_per_expert: int) -> SlotMaps:
    """``maps`` seen from the rank that holds experts ``[shard * e_local,
    (shard + 1) * e_local)``: its capacity rows (a contiguous block, the
    rows being expert-major) renumbered from 0, and every capacity row of
    another rank's experts sent to the zero row past its own."""
    n = e_local * rows_per_expert
    lo = shard * n

    def mine(rows: torch.Tensor) -> torch.Tensor:
        return torch.where((rows >= lo) & (rows < lo + n), rows - lo, n)

    return SlotMaps(maps.token[lo:lo + n], mine(maps.choices), maps.assignment[lo:lo + n],
                    mine(maps.assignment_row))


def _moe_chunk_mesh(params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_chunk` on a mesh: x a DTensor at ``"btd"`` (groups, the
    batch rows, over the data axes), the expert weights' expert dim over
    the model axes (the reference's ``param_placements``).  Four
    ``local_map`` calls, each on a rank's own groups: the routing (the
    router whole on every rank, every expert scored); the dispatch (the
    slot maps of all experts, then the rows of this rank's experts: its
    share of the reference's ``"gecd"`` buffer); the rank's experts'
    products; the combine, each token's slots of this rank's experts
    summed in ascending expert id as on one card, a partial sum over the
    model axes that the ``"btd"`` placement reduces (the reference's EP
    combine).  The balance loss is taken over every group: the routing's
    probabilities and choices gathered whole, in rank order, then the
    one-card sums.

    On a (1, 1) mesh every bit equals :func:`_moe_chunk`'s.  Where the
    experts split over the model axes a token's output is the sum of each
    rank's partial sums, which rounds otherwise than one left-to-right sum
    over its k slots."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    nd = mesh.ndim
    x = shard(x, "btd")
    x_pl = tuple(x.placements)
    batch = [i for i, p in enumerate(x_pl) if p == Shard(0)]
    experts = [i for i, p in enumerate(params["w_gate"].placements) if p == Shard(0)]
    shard_idx, n_shards = mesh_rank(mesh, experts)
    e_local = cfg.n_experts // n_shards
    _, t_dim, d = x.shape
    cap = capacity(t_dim, cfg)

    def pl(**dims: Any) -> tuple:
        """One placement a mesh dim: ``batch=`` on the batch dims,
        ``experts=`` on the expert dims, Replicate elsewhere."""
        return tuple(dims["batch"] if i in batch and "batch" in dims
                     else dims["experts"] if i in experts and "experts" in dims
                     else Replicate() for i in range(nd))

    rep = pl()
    groups = pl(batch=Shard(0))

    # routing: every expert scored on each rank's groups
    aux_free = cfg.router_aux_free
    route_in = [params["router"]] + ([params["router_bias"].detach()] if aux_free else [])

    def route(xl, router, bias=None):
        p = {"router": router} if bias is None else {"router": router, "router_bias": bias}
        w, idx, probs, counts = _route_parts(p, xl, cfg)
        return (w, idx) if aux_free else (w, idx, probs, counts)

    routed = local_map(route, out_placements=(groups,) * (2 if aux_free else 4),
                       in_placements=(x_pl,) + (rep,) * len(route_in),
                       in_grad_placements=(x_pl, pl(batch=Partial())) + (rep,) * aux_free,
                       device_mesh=mesh, redistribute_inputs=True)(x, *route_in)
    w, idx = routed[:2]
    if aux_free:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        aux = _balance_loss(routed[2].redistribute(mesh, rep), routed[3].redistribute(mesh, rep),
                            cfg, x.device)

    # dispatch: this rank's experts' rows of each of its groups
    gecd = pl(batch=Shard(0), experts=Shard(1))
    by_slot = pl(batch=Shard(0), experts=Shard(0))  # capacity rows of the rank's experts
    by_token = pl(batch=Shard(0), experts=Shard(1))  # token rows, columns localized per rank

    def dispatch(xl, idxl):
        g = xl.shape[0]
        tok_slot, k_slot = _dispatch_indices(idxl, t_dim, cfg, cap)
        maps = _local_maps(_slot_maps(tok_slot, k_slot, t_dim, cfg.experts_per_token),
                           shard_idx, e_local, g * cap)
        xs = _GatherRows.apply(xl.reshape(g * t_dim, d), maps.token, maps.choices)
        return (xs.view(e_local, g, cap, d).transpose(0, 1), maps.token, maps.choices,
                maps.assignment, maps.assignment_row)

    xs, tok_map, choice_map, asg_map, asg_row_map = local_map(
        dispatch, out_placements=(gecd, by_slot, by_token, by_slot, by_token),
        in_placements=(x_pl, groups), in_grad_placements=(pl(batch=Shard(0),
                                                              experts=Partial()), groups),
        device_mesh=mesh, redistribute_inputs=True)(x, idx)
    xs = shard(xs, "gecd")

    # the rank's experts on its rows, weights gathered over the data axes
    w_pl = pl(experts=Shard(0))
    w_grad = pl(batch=Partial(), experts=Shard(0))

    def products(xsl, wg, wu, wd):
        g = xsl.shape[0]
        flat = xsl.transpose(0, 1).reshape(e_local, g * cap, d)  # the dispatch buffer's own rows
        ys = _expert_ffn({"w_gate": wg, "w_up": wu, "w_down": wd}, flat)
        return ys.view(e_local, g, cap, d).transpose(0, 1)

    ys = local_map(products, out_placements=list(gecd), in_placements=(gecd, w_pl, w_pl, w_pl),
                   in_grad_placements=(gecd, w_grad, w_grad, w_grad), device_mesh=mesh,
                   redistribute_inputs=True)(xs, params["w_gate"], params["w_up"],
                                             params["w_down"])
    ys = shard(ys, "gecd")

    # combine: each token's slots of this rank's experts, in expert order
    def combine(ysl, wl, tok, choices, asg, asg_row):
        g = ysl.shape[0]
        y = ysl.transpose(0, 1).reshape(-1, d)
        ws = _GatherRows.apply(wl.reshape(-1, 1), asg, asg_row)
        y = y * ws.to(y.dtype)
        return _GatherRows.apply(y, choices, tok).view(g, t_dim, d)

    out = local_map(combine, out_placements=list(pl(batch=Shard(0), experts=Partial())),
                    in_placements=(gecd, groups, by_slot, by_token, by_slot, by_token),
                    in_grad_placements=(gecd, pl(batch=Shard(0), experts=Partial()), by_slot,
                                        by_token, by_slot, by_token),
                    device_mesh=mesh, redistribute_inputs=True)(
        ys, w, tok_map, choice_map, asg_map, asg_row_map)
    return shard(out, "btd"), aux


def apply(params, x: torch.Tensor, cfg: ModelConfig, *,
          token_chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Groups = batch rows; long sequences
    run chunk by chunk so one capacity buffer is live at a time, and aux is
    the mean of the chunks'.  A DTensor x on a mesh (under
    ``act_sharding.use_rules``) runs :func:`_moe_chunk_mesh`."""
    b, s, d = x.shape
    chunk = (_moe_chunk_mesh if act_sharding.active()[0] is not None and is_dtensor(x)
             else _moe_chunk)
    if s > token_chunk and s % token_chunk == 0:
        outs, auxs = [], []
        for i in range(s // token_chunk):
            out_i, aux_i = chunk(params, x[:, i * token_chunk:(i + 1) * token_chunk], cfg)
            outs.append(out_i)
            auxs.append(aux_i)
        out, aux = torch.cat(outs, dim=1), torch.mean(torch.stack(auxs))
    else:
        out, aux = chunk(params, x, cfg)
    if cfg.n_shared_experts:
        out = out + ffn.apply(params["shared"], x)
    return out, aux


def moe_ref(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: dense per-token expert evaluation (no capacity drops).

    Matches :func:`apply` exactly when no expert exceeds capacity.
    """
    w, idx, _ = _route(params, x, cfg)
    out = torch.zeros_like(x)
    for kk in range(cfg.experts_per_token):
        e_ids = idx[..., kk]  # (b, s)
        wg, wu, wd = (params[n][e_ids].to(x.dtype) for n in ("w_gate", "w_up", "w_down"))
        gate = torch.einsum("bsd,bsdf->bsf", x, wg)
        up = torch.einsum("bsd,bsdf->bsf", x, wu)
        y = torch.einsum("bsf,bsfd->bsd", torch.nn.functional.silu(gate) * up, wd)
        out = out + y * w[..., kk, None]
    if cfg.n_shared_experts:
        out = out + ffn.apply(params["shared"], x)
    return out
