"""GPipe pipeline parallelism over logical stages on one card (port of
``repro.distributed.pipeline``).

The reference shards a stack of stages over a ``pipe`` mesh axis and streams
M microbatches through a ``lax.scan`` of M + S - 1 ticks: at tick t stage s
holds microbatch t - s, its output hops to stage s + 1 by ``lax.ppermute``,
and the last stage's outputs are collected.  Autodiff of the scan is the
GPipe backward.

Here the S stages are logical: all of them live on one device, the
``ppermute`` is a hand-off of the activation one stage produced to the
stage after it at the next tick, and autograd through the schedule is the
backward.  Stages run one after another inside a tick (no stream per
stage: overlapping them would be a performance change, not a port).

Both functions apply ``stage_fn`` to one microbatch at a time, in the same
order per microbatch, so on one device the pipeline equals the sequential
pass bit for bit, values and gradients: the backward runs each stage's
calls in descending microbatch order under both schedules (autograd runs
ready nodes newest first, and every node's consumer is newer than it), so
each parameter's gradient sums its microbatches' terms in the same order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any  # a tensor, or dicts / lists / tuples of them


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def num_stages(stage_params: Tree) -> int:
    """S: the leading dim of the stage parameters' leaves.

    Raises:
        ValueError: a leaf's leading dim differs from the others'.
    """
    sizes = set()
    _tree_map(lambda t: sizes.add(t.shape[0]), stage_params)
    if len(sizes) != 1:
        raise ValueError(f"pipeline: stage parameters disagree on the stage count: "
                         f"{sorted(sizes)}")
    return sizes.pop()


def stage_slices(stage_params: Tree) -> list[Tree]:
    """One tree per stage: the leaves' slices ``[s]`` (views, nothing
    copied), taken once, so that each stage's gradient flows through one
    slice of each leaf."""
    n = num_stages(stage_params)
    return [_tree_map(lambda t, s=s: t[s], stage_params) for s in range(n)]


def pipeline_forward(
    stage_params: Tree,
    x_microbatches: torch.Tensor,
    stage_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
    *,
    stages: int | None = None,
) -> torch.Tensor:
    """Run ``x_microbatches`` (M, mb, ...) through S stages on the GPipe
    schedule; returns the last stage's (M, mb, ...) outputs.

    ``stage_params``: leaves with a leading dim S; ``stage_fn(params_s, x)``
    applies one stage to one microbatch.  ``stages``, where given, must be
    S (the reference reads it from the mesh's ``pipe`` axis).

    Raises:
        ValueError: ``stages`` is not the leaves' leading dim, or there is no
            microbatch.
    """
    per_stage = stage_slices(stage_params)
    n = len(per_stage)
    if stages is not None and stages != n:
        raise ValueError(f"pipeline: stages={stages}, but the parameters hold {n} stages")
    m = x_microbatches.shape[0]
    if m == 0:
        raise ValueError("pipeline: no microbatch")
    held: list[torch.Tensor | None] = [None] * n  # the input each stage holds
    outs: list[torch.Tensor | None] = [None] * m
    for t in range(m + n - 1):
        passed: list[torch.Tensor | None] = [None] * n
        for s in range(n):
            mb = t - s  # the microbatch stage s holds at tick t
            if not 0 <= mb < m:
                continue
            y = stage_fn(per_stage[s], x_microbatches[mb] if s == 0 else held[s])
            if s == n - 1:
                outs[mb] = y  # the last stage's output is collected
            else:
                passed[s + 1] = y  # the hop to the next stage (ppermute)
        held = passed
    return torch.stack(outs)


def sequential_reference(
    stage_params: Tree,
    x_microbatches: torch.Tensor,
    stage_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Oracle: every stage in order on each microbatch, one microbatch at a
    time (the reference vmaps over them; the port keeps them apart, as the
    pipeline does)."""
    per_stage = stage_slices(stage_params)
    outs = []
    for mb in range(x_microbatches.shape[0]):
        x = x_microbatches[mb]
        for p in per_stage:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)
