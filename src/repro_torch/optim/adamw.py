"""AdamW with warmup-cosine schedule, global-norm clipping, and a
memory-precision knob for the optimizer moments (port of
``repro.optim.adamw``; f32 moments by default, bf16 halves their memory).

A tree here is the port's model (an ``nn.Module``: its
``named_parameters()``) or a mapping of names to tensors, nested dicts
flattened to ``"a/b"`` names; the moments are flat ``{name: tensor}``
dicts under the same names.  The reference is functional; the port updates
the parameters and the moments in place, leaf by leaf and in chunks of
:data:`CHUNK` elements, so that the temporaries stay a few chunks in size
however large a leaf is (a 4 B-parameter model leaves ~16 GB free on an
80 GB card).  Elementwise arithmetic is the reference's, in f32; the
scalars (clip, learning rate, bias corrections) are 0-dim f32 tensors on
the parameters' device, so a step never waits for the host.

On a mesh the parameters, gradients and moments are DTensors at one
placement each (``distributed.sharding.param_placements``; a gradient is
brought to its parameter's placement first, by ``train_step``).  The
chunks then run over each leaf's local shard (``to_local()``: ``view(-1)``
of a sharded DTensor is no local view), with the same f32 ops in the same
order.  :func:`global_norm` sums the squares of every rank's shards,
counts a replicated leaf once (on the ranks at coordinate 0 of the mesh
dims it is replicated over) and all-reduces the sum over the mesh, so
every rank clips by the same norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Mapping

import torch

from repro_torch.distributed.sharding import is_dtensor as _is_dtensor

CHUNK = 1 << 24  # elements per slice of a leaf in global_norm and update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # bf16 halves optimizer memory


def named_leaves(tree: Any) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module (its parameters) or of a mapping
    (nested dicts flattened to ``"a/b"``, sorted keys as the reference
    flattens them)."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key in sorted(node):
            value = node[key]
            name = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, name + "/")
            else:
                out[name] = value

    walk(tree, "")
    return out


def schedule(cfg: AdamWConfig, step: torch.Tensor | int) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine from the
    peak to ``min_lr_ratio`` of it, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_beside(p: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if _is_dtensor(p):
        return torch.zeros_like(p, dtype=dt)  # the parameter's placements
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init(params: Any, cfg: AdamWConfig) -> dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` beside every leaf (a DTensor
    leaf's at its placements) and a step count of 0 (int32, on the leaves'
    device)."""
    dt = getattr(torch, cfg.moment_dtype)
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device if leaves else None
    return {
        "m": {n: _zeros_beside(p, dt) for n, p in leaves.items()},
        "v": {n: _zeros_beside(p, dt) for n, p in leaves.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the same storage), or ``x``."""
    return x.to_local() if _is_dtensor(x) else x


def _chunks(x: torch.Tensor) -> Iterator[torch.Tensor]:
    return iter(_local(x).view(-1).split(CHUNK))


def _counted_here(x: torch.Tensor) -> bool:
    """Whether this rank's shard of ``x`` enters the norm: a plain tensor's
    always, a DTensor's where this rank sits at coordinate 0 of every mesh
    dim the leaf is replicated over (each element once over the mesh)."""
    if not _is_dtensor(x):
        return True
    from torch.distributed.tensor import Replicate, Shard

    coord = x.device_mesh.get_coordinate()
    for c, p in zip(coord, x.placements):
        if not isinstance(p, (Replicate, Shard)):
            raise ValueError(f"global_norm takes sharded or replicated leaves, not {p}")
        if isinstance(p, Replicate) and c != 0:
            return False
    return True


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in f32; over a mesh,
    of every element once, the same on every rank."""
    leaves = list(named_leaves(tree).values())
    parts = [torch.sum(torch.square(c.to(torch.float32)))
             for x in leaves if _counted_here(x) for c in _chunks(x.detach())]
    if not leaves or not _is_dtensor(leaves[0]):
        return torch.sqrt(torch.sum(torch.stack(parts)))
    dist = torch.distributed
    mesh = leaves[0].device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"global_norm reduces over the world: a mesh of {mesh.size()} ranks in "
                         f"a world of {dist.get_world_size()}")
    total = (torch.sum(torch.stack(parts)) if parts
             else torch.zeros((), dtype=torch.float32, device=_local(leaves[0]).device))
    dist.all_reduce(total)  # one sum over every rank: the same bits on each
    return torch.sqrt(total)


@torch.no_grad()
def update(
    grads: Any, state: dict[str, Any], params: Any, cfg: AdamWConfig,
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}).

    ``params`` and the moments are updated in place and returned; ``state``
    gets the new count.  ``grads`` is read only.  Per leaf, as the
    reference: ``g = grad * clip``, ``m = b1 m + (1 - b1) g``,
    ``v = b2 v + (1 - b2) g g``, ``p -= lr (m / b1c / (sqrt(v / b2c) + eps)
    + wd p)`` in f32, with ``clip = min(1, grad_clip / max(|grads|, 1e-9))``
    and ``b1c = 1 - b1 ** count`` in f32.  Weight decay applies to every
    leaf, norms included.
    """
    p_leaves, g_leaves = named_leaves(params), named_leaves(grads)
    if p_leaves.keys() != g_leaves.keys():
        raise ValueError(f"grads and params name other leaves: "
                         f"{sorted(p_leaves.keys() ^ g_leaves.keys())[:4]}")
    f32 = torch.float32
    count = state["count"] + 1
    gnorm = global_norm(g_leaves)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, count)
    countf = count.to(f32)
    b1c = 1 - torch.pow(cfg.b1, countf)
    b2c = 1 - torch.pow(cfg.b2, countf)
    for name, p in p_leaves.items():
        grad = g_leaves[name]
        if _is_dtensor(p) and tuple(grad.placements) != tuple(p.placements):
            raise ValueError(f"{name}: gradient at {grad.placements}, parameter at "
                             f"{p.placements}")
        parts = zip(_chunks(p.detach()), _chunks(grad), _chunks(state["m"][name]),
                    _chunks(state["v"][name]))
        for pc, gc, mc, vc in parts:  # each op rounds where the reference's does
            g = gc.to(f32) * clip
            m32 = mc if mc.dtype == f32 else mc.to(f32)
            v32 = vc if vc.dtype == f32 else vc.to(f32)
            m32.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v32.mul_(cfg.b2).add_(g.mul(1 - cfg.b2).mul_(g))
            if m32 is not mc:
                mc.copy_(m32)
                vc.copy_(v32)
            step = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps))
            p32 = pc if pc.dtype == f32 else pc.to(f32)
            step.add_(p32 * cfg.weight_decay)
            p32.sub_(step.mul_(lr))
            if p32 is not pc:
                pc.copy_(p32)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
