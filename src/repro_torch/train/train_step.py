"""Training step factory: loss + grad (+ microbatched accumulation) + AdamW
(port of ``repro.train.train_step``).

Gradient accumulation runs the microbatches one after another: each
re-runs the remat'd forward and backward and adds its gradients into the
accumulator, which bounds activation memory to one microbatch.

On a mesh (DTensor parameters, under ``distributed.act_sharding.use_rules``)
each gradient is brought to its parameter's placements as it comes out of
the backward (a partial sum over the mesh is reduced there), which is what
the reference's ``param_shardings`` pins its accumulator to; the argument
is taken and ignored.  The metrics come back whole on every rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, whole
from repro_torch.models import registry
from repro_torch.optim import adamw


def make_loss_fn(cfg: ModelConfig, **loss_kwargs) -> Callable[..., Any]:
    api = registry.get(cfg)

    def loss_fn(params: Any, batch: dict[str, torch.Tensor]):
        return api.loss_fn(params, batch, cfg, **loss_kwargs)

    return loss_fn


def _at_param(p: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """``g`` contiguous and, for a DTensor parameter, at its placements; a
    zero gradient where the loss does not reach ``p``."""
    if g is None:
        return torch.zeros_like(p)
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.contiguous()


def make_grad_fn(
    cfg: ModelConfig, *, microbatches: int = 1, grad_acc_dtype: str = "float32", **loss_kwargs,
) -> Callable[..., Any]:
    """Returns grad_fn(params, batch) -> (grads, metrics): the gradient of
    the loss with respect to every parameter of ``params`` (the port's
    model, with ``requires_grad`` on) as ``{name: tensor}`` in
    ``named_parameters()`` order, contiguous, zeros for a leaf the loss does
    not reach, and the loss's metrics detached.

    With ``microbatches`` > 1 the batch is split along its first dim;
    gradients add up in ``grad_acc_dtype`` and metrics in f32, and both are
    divided by the count, as the reference does.
    """
    loss_fn = make_loss_fn(cfg, **loss_kwargs)
    acc_dt = getattr(torch, grad_acc_dtype)

    def value_and_grad(params: Any, batch: dict[str, torch.Tensor]):
        named = dict(params.named_parameters())
        _, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(metrics["loss"], list(named.values()), allow_unused=True)
        # a leaf the loss does not reach (the MoE router_bias, read detached)
        # gets a zero gradient, as jax.grad gives it; every gradient is
        # contiguous, as the optimizer's flat chunks need (an einsum's
        # backward may give a permuted one: the sLSTM's r_gates)
        grads = [_at_param(p, g) for p, g in zip(named.values(), grads)]
        return dict(zip(named, grads)), {k: whole(v) for k, v in metrics.items()}

    def grad_fn(params: Any, batch: dict[str, torch.Tensor]):
        if microbatches == 1:
            return value_and_grad(params, batch)
        if batch["tokens"].shape[0] % microbatches:
            raise ValueError(f"batch {batch['tokens'].shape[0]} does not split into "
                             f"{microbatches} microbatches")
        parts = {k: x.chunk(microbatches, dim=0) for k, x in batch.items()}
        g_acc: dict[str, torch.Tensor] = {}
        m_acc: dict[str, torch.Tensor] = {}
        for i in range(microbatches):
            g, metrics = value_and_grad(params, {k: v[i] for k, v in parts.items()})
            for n, x in g.items():
                if n in g_acc:
                    g_acc[n] += x.to(acc_dt)
                else:
                    g_acc[n] = torch.zeros_like(x, dtype=acc_dt) + x.to(acc_dt)
            for k, v in metrics.items():
                m_acc[k] = m_acc[k] + v.to(torch.float32) if k in m_acc else v.to(torch.float32)
        return ({n: g / microbatches for n, g in g_acc.items()},
                {k: v / microbatches for k, v in m_acc.items()})

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    microbatches: int = 1,
    grad_acc_dtype: str = "float32",
    param_shardings: Any = None,
    **loss_kwargs,
) -> Callable[..., Any]:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): :func:`make_grad_fn`'s gradients, then
    :func:`repro_torch.optim.adamw.update` (in place).  Metrics: the
    loss's (``nll``, ``aux``, ``loss``, ...) plus ``grad_norm`` and ``lr``.

    ``param_shardings`` is accepted for the reference's signature and
    ignored: each gradient takes its parameter's own placements.
    """
    del param_shardings
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    grad_fn = make_grad_fn(cfg, microbatches=microbatches, grad_acc_dtype=grad_acc_dtype,
                           **loss_kwargs)

    def train_step(params: Any, opt_state: dict[str, Any], batch: dict[str, torch.Tensor]):
        grads, metrics = grad_fn(params, batch)
        params, opt_state, om = adamw.update(grads, opt_state, params, opt_cfg)
        del grads
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
