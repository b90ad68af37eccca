"""Shared model machinery (port of ``repro.models.common``): parameter
specs and their initialisation, the parameter container, norms, RoPE,
embeddings and the loss.

Every module defines a ``spec(cfg) -> {name: ParamSpec | nested dict}``;
:func:`init_params` materialises it from a ``torch.Generator``, leaf by
leaf with the reference's rule, and :class:`ParamTree` holds the result as
an ``nn.Module`` whose entries read as ``params["attn"]["wq"]``, so the
model code reads like the reference's.  Of the reference's custom VJPs,
``rmsnorm``'s backward is ported (:class:`RMSNorm`) and
``grad_safe_barrier`` is an identity (see its docstring);
``shape_tree``/``axes_tree`` serve the TPU dry-run and sharding resolver,
which the port does not have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


SpecTree = dict[str, Any]  # nested dicts of ParamSpec


def tree_leaves(tree: dict[str, Any] | list[Any],
                prefix: tuple[str | int, ...] = ()) -> list[tuple[tuple[str | int, ...], Any]]:
    """(path, leaf) pairs in the reference's flattening order
    (``jax.tree.flatten``): a dict's keys sorted, a list's entries in index
    order (an ``int`` in the path: xLSTM's ``blocks/10`` comes after
    ``blocks/9``), depth first."""
    out = []
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    for name, v in items:
        if isinstance(v, (dict, list)):
            out.extend(tree_leaves(v, prefix + (name,)))
        else:
            out.append((prefix + (name,), v))
    return out


def path_name(path: tuple[str | int, ...], sep: str = "/") -> str:
    """A :func:`tree_leaves` path as text: ``blocks/10/cell/w_up``."""
    return sep.join(map(str, path))


def tree_set(tree: dict[str, Any] | list[Any], path: tuple[str | int, ...], value: Any) -> None:
    """Put ``value`` at ``path``, making the dicts (a ``str`` key) and lists
    (an ``int`` index) on the way."""
    for name, nxt in zip(path, path[1:] + (None,)):
        new = value if nxt is None else ([] if isinstance(nxt, int) else {})
        if isinstance(tree, list):
            tree.extend([None] * (name + 1 - len(tree)))
            if tree[name] is None or nxt is None:
                tree[name] = new
        elif nxt is None or name not in tree:
            tree[name] = new
        tree = tree[name]


def init_params(
    spec: SpecTree, generator: torch.Generator, dtype: torch.dtype = torch.float32,
    *, place: Callable[[tuple[str | int, ...], torch.Tensor], Any] | None = None,
) -> dict[str, Any]:
    """Materialise ``spec`` on the generator's device: zeros, ones, or
    ``scale * N(0, 1)`` drawn in ``dtype``.

    The scale rule is the reference's: ``spec.scale`` if given, else 1.0
    for ``embed`` leaves and ``1/sqrt(fan_in)`` for ``normal`` leaves, where
    ``fan_in = shape[0]``.  For a scan-stacked leaf ``shape[0]`` is the
    layer count (``wq`` (36, 2560, 32, 128) gets std 1/6): the reference's
    rule, kept so that activations have its magnitudes.  The numbers are
    torch's, not ``jax.random``'s.

    ``place(path, leaf)`` gives what the tree keeps of each leaf as soon as
    it is drawn (a mesh run's shard of it), so no more than one whole leaf
    lives at a time; the draws keep their order and bits.
    """
    out: dict[str, Any] = {}
    dev = generator.device
    for path, s in tree_leaves(spec):
        if s.init == "zeros":
            x = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            x = torch.ones(s.shape, dtype=dtype, device=dev)
        else:
            fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[0], 1)
            if s.init == "embed":
                scale = s.scale if s.scale is not None else 1.0
            else:
                scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
            x = torch.randn(s.shape, generator=generator, dtype=dtype, device=dev)
            x.mul_(scale)
        tree_set(out, path, x if place is None else place(path, x))
    return out


def stack_specs(spec: SpecTree, n: int) -> SpecTree:
    """Prefix every param with a scan-stacked 'layers' dim."""
    return {
        k: stack_specs(v, n) if isinstance(v, dict)
        else ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.init, v.scale)
        for k, v in spec.items()
    }


def unstack(tree: dict[str, Any], n: int) -> list[dict[str, Any]]:
    """Split every ``(n, ...)`` leaf of a stacked tree into ``n`` per-layer
    trees (views of the stacked tensors; nothing is copied)."""
    layers: list[dict[str, Any]] = [{} for _ in range(n)]
    for path, x in tree_leaves(tree):
        if x.shape[0] != n:
            raise ValueError(f"{path_name(path)}: leading dim {x.shape[0]}, expected {n} layers")
        for i, xi in enumerate(x.unbind(0)):
            tree_set(layers[i], path, xi)
    return layers


class ParamTree(nn.Module):
    """A tree of parameters: tensors become (frozen) ``nn.Parameter``\\ s,
    dicts become sub-trees, lists become ``nn.ModuleList``\\ s of sub-trees.
    ``params["name"]`` reads an entry, as the reference indexes its dicts.

    Serving leaves every parameter frozen, so no forward records a graph;
    training turns ``requires_grad`` on for every leaf (:func:`trainable`)."""

    def __init__(self, tree: dict[str, Any]):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(t) for t in v))

    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)


def trainable(params: nn.Module) -> nn.Module:
    """Turn ``requires_grad`` on for every parameter (each per-layer view of a
    stacked tensor is its own autograd leaf); returns ``params``."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def grad_safe_barrier(x: torch.Tensor) -> torch.Tensor:
    """The identity.  The reference pins each layer's residual with an
    ``optimization_barrier`` (forward and cotangent) so that XLA cannot
    hoist its f32 upcast out of the backward layer scan as a stack-wide
    copy; eager PyTorch runs each op where it is written and hoists
    nothing, so there is nothing to pin."""
    return x


def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    var = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv32 = torch.rsqrt(var + eps)  # (...,) f32 row statistics
    return (x * inv32[..., None].to(x.dtype)) * w.to(x.dtype), inv32


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with the reference's custom backward
    (``_rmsnorm_bwd``): it keeps x in its own dtype and the f32 row
    statistics, and computes ``gw = g w``, ``s = sum(gw x)``,
    ``dx = gw inv - x inv^3 s / d`` and ``dw = sum(g x inv)`` in f32,
    narrowing dx to x's dtype and dw to w's, as the reference does."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out, inv32 = _rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, inv32, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x, inv32, w = ctx.saved_tensors
        g = _whole_rows(g, x)
        f32, d = torch.float32, x.shape[-1]
        xf = x.to(f32)
        gw = g.to(f32) * w.to(f32)
        s = torch.sum(gw * xf, dim=-1)
        inv = inv32[..., None]
        dx = (gw * inv - xf * (inv**3) * (s / d)[..., None]).to(x.dtype)
        dw = _row_sum(g.to(f32) * xf * inv).to(w.dtype)
        return dx, dw, None


def _whole_rows(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``g`` as it is, or on a mesh at ``x``'s placements (whole rows): a
    gradient that arrives partial over the model axes, or with its last dim
    split (the tied head's backward splits d_model over the data axes),
    is reduced first, else DTensor's propagation may reduce-scatter it over
    the rows the norm's backward sums."""
    from repro_torch.distributed.sharding import is_dtensor

    if not is_dtensor(g):
        return g
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return g if tuple(g.placements) == want else g.redistribute(x.device_mesh, want)


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (d,): the sum over every row, as ``reshape(-1, d)`` then
    a sum.  A DTensor (a mesh run) sums its own rows the same way and gives
    a partial sum over the mesh dims that split them, and the sum's own
    columns over the mesh dims that split ``d`` (a norm over ``"mlp"``
    channels, Mamba2's and xLSTM's): the one-card path's op on each rank (a
    view that flattens a sharded dim is refused)."""
    from repro_torch.distributed.sharding import is_dtensor

    d = t.shape[-1]
    if not is_dtensor(t):
        return t.reshape(-1, d).sum(dim=0)
    from torch.distributed.tensor import DTensor, Partial, Shard

    pl = []
    for p in t.placements:
        if isinstance(p, Shard):
            pl.append(Shard(0) if p.dim in (-1, t.ndim - 1) else Partial())
        else:
            pl.append(p)
    local = t.to_local().reshape(-1, t.to_local().shape[-1]).sum(dim=0)
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False, shape=torch.Size((d,)),
                              stride=(1,))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 row statistics: the variance of x in f32, its
    inverse square root narrowed to x's dtype, then ``x * inv * w``, as the
    reference's forward does.  Under grad, with x or w requiring it, the
    same forward runs inside :class:`RMSNorm` (the reference's backward);
    serving calls the forward alone."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)[0]


def conv_on_channels(conv: Callable, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A depthwise causal conv on a mesh, each rank on its own channels:
    ``conv(x, w, b, state) -> (out, new state | None)`` through one
    ``local_map``, x (B, S, C) at ``"btf"`` (batch rows over the data axes,
    channels over the model axes where they divide), the taps ``w`` (K, C)
    and bias ``b`` (C,) on the same channels (their gradients partial sums
    over the data axes), the state (B, K-1, C) at ``"btf"``: the reference's
    ``conv`` state rule."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import act_sharding

    ch = act_sharding.placements("btf", tuple(x.shape))
    n = len(ch)
    chans = [i for i, q in enumerate(ch) if q == Shard(2)]
    batch = [i for i, q in enumerate(ch) if q == Shard(0)]

    def on(dim: int, grad: bool = False) -> tuple:
        return tuple(Shard(dim) if i in chans else Partial() if grad and i in batch
                     else Replicate() for i in range(n))

    if state is not None and tuple(state.placements) != ch:
        raise RuntimeError(f"a conv state at {tuple(state.placements)}, expected {ch}")
    args, pls, grads = (x, w, b), (ch, on(1), on(0)), (ch, on(1, True), on(0, True))
    if state is None:
        out = local_map(lambda xl, wl, bl: conv(xl, wl, bl, None)[0], out_placements=list(ch),
                        in_placements=pls, in_grad_placements=grads, device_mesh=x.device_mesh,
                        redistribute_inputs=True)(*args)
        return out, None
    return local_map(conv, out_placements=(ch, ch), in_placements=pls + (ch,),
                     in_grad_placements=grads + (ch,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(*args, state)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rope_freqs(head_dim: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies.  ``theta`` stays a Python scalar:
    a tensor made from it would be a host-to-device copy, which waits for
    the stream on every call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half (the two halves of the head dim, not
    interleaved pairs). x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean token NLL; logits (..., vocab) computed in fp32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = _pick(lf, labels.long())
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _pick(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lf[..., labels]``: a gather, or on a mesh (DTensor logits) each rank's
    pick from its own vocab columns, zeros elsewhere: a partial sum over
    the vocab's mesh dims, exact (one term and zeros)."""
    from repro_torch.distributed.sharding import is_dtensor

    if not is_dtensor(lf):
        return torch.gather(lf, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = lf.device_mesh, lf.ndim - 1
    lf_pl = tuple(p if isinstance(p, Shard) else Replicate() for p in lf.placements)
    vocab_dims = [i for i, p in enumerate(lf_pl) if p == Shard(last)]
    # the labels lie as the logits' rows do, whole where the vocab is split
    lab_pl = tuple(p if isinstance(p, Shard) and p.dim < last else Replicate() for p in lf_pl)
    out_pl = [Partial() if i in vocab_dims else lab_pl[i] for i in range(mesh.ndim)]
    lo = _rank_offset(mesh, vocab_dims, lf.shape[-1])

    def local(x, lab):
        rel = lab - lo
        mine = (rel >= 0) & (rel < x.shape[-1])
        got = torch.gather(x, -1, torch.where(mine, rel, 0)[..., None])[..., 0]
        return torch.where(mine, got, 0.0) if vocab_dims else got

    fn = local_map(local, out_placements=out_pl, in_placements=(lf_pl, lab_pl),
                   in_grad_placements=(lf_pl, lab_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(lf, labels)


def _rank_offset(mesh: Any, dims: list[int], n: int) -> int:
    """The first index of this rank's block of a dim of ``n`` split evenly
    over the mesh dims ``dims`` (major first); 0 over none."""
    from repro_torch.distributed.sharding import mesh_rank

    r, shards = mesh_rank(mesh, dims)
    return r * (n // shards)


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding rows (a gather).  Its gradient sums each token's rows
    into the embedding's (``F.embedding``'s backward, which sorts the
    tokens: the same bits on every run, on the card too).  A DTensor table
    (a mesh run) goes through :func:`_sharded_lookup`."""
    from repro_torch.distributed.sharding import is_dtensor

    if is_dtensor(embedding):
        return _sharded_lookup(embedding, tokens)
    return torch.nn.functional.embedding(tokens.long(), embedding)


def _sharded_lookup(embedding, tokens):
    """The lookup on a mesh, each rank on its own rows of the table: the
    table whole along d_model (gathered over the axes its 'embed' dim
    shards on), its vocab rows where they lie (the reference's 'vocab'
    over the model axes); the tokens in their batch rows.  A rank looks up
    the tokens its rows hold and gives zeros for the others, so the output
    is a partial sum over the vocab's mesh dims, and the table's gradient
    a partial sum over the batch's (``in_grad_placements``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embedding.device_mesh
    tokens = tokens if tokens.dtype == torch.long else tokens.long()
    vocab_dims = [i for i, p in enumerate(embedding.placements) if p == Shard(0)]
    batch_dims = [i for i, p in enumerate(tokens.placements) if p == Shard(0)]
    table_pl = tuple(Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim))
    table_grad_pl = tuple(Shard(0) if i in vocab_dims else Partial() if i in batch_dims
                          else Replicate() for i in range(mesh.ndim))
    out_pl = tuple(Partial() if i in vocab_dims else tokens.placements[i]
                   for i in range(mesh.ndim))
    lo = _rank_offset(mesh, vocab_dims, embedding.shape[0])

    def local(table, toks):
        if not vocab_dims:
            return torch.nn.functional.embedding(toks, table)
        rel = toks - lo
        mine = (rel >= 0) & (rel < table.shape[0])
        rows = torch.nn.functional.embedding(torch.where(mine, rel, 0), table)
        return torch.where(mine[..., None], rows, 0.0)

    fn = local_map(local, out_placements=list(out_pl), in_placements=(table_pl, tokens.placements),
                   in_grad_placements=(table_grad_pl, tokens.placements), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(embedding, tokens)
