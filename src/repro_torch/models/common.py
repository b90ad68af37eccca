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
from typing import Any

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
) -> dict[str, Any]:
    """Materialise ``spec`` on the generator's device: zeros, ones, or
    ``scale * N(0, 1)`` drawn in ``dtype``.

    The scale rule is the reference's: ``spec.scale`` if given, else 1.0
    for ``embed`` leaves and ``1/sqrt(fan_in)`` for ``normal`` leaves, where
    ``fan_in = shape[0]``.  For a scan-stacked leaf ``shape[0]`` is the
    layer count (``wq`` (36, 2560, 32, 128) gets std 1/6): the reference's
    rule, kept so that activations have its magnitudes.  The numbers are
    torch's, not ``jax.random``'s.
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
        tree_set(out, path, x)
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
        f32, d = torch.float32, x.shape[-1]
        xf = x.to(f32)
        gw = g.to(f32) * w.to(f32)
        s = torch.sum(gw * xf, dim=-1)
        inv = inv32[..., None]
        dx = (gw * inv - xf * (inv**3) * (s / d)[..., None]).to(x.dtype)
        dw = (g.to(f32) * xf * inv).reshape(-1, d).sum(dim=0).to(w.dtype)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 row statistics: the variance of x in f32, its
    inverse square root narrowed to x's dtype, then ``x * inv * w``, as the
    reference's forward does.  Under grad, with x or w requiring it, the
    same forward runs inside :class:`RMSNorm` (the reference's backward);
    serving calls the forward alone."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)[0]


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
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding rows (a gather).  Its gradient sums each token's rows
    into the embedding's (``F.embedding``'s backward, which sorts the
    tokens: the same bits on every run, on the card too)."""
    return torch.nn.functional.embedding(tokens.long(), embedding)
