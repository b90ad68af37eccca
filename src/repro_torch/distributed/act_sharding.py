"""Activation placements on a DeviceMesh (port of
``repro.distributed.act_sharding``).

Models call ``shard(x, kind)`` at the reference's sites; a launcher
installs the mesh and its rules with ``use_rules``.  Under rules, a DTensor
is redistributed to the kind's placements: the batch dim over the data
axes, the kind's ``'model'`` dim over the model axes where it divides them
(else replicated, as in the reference), every other dim whole.  Without
rules, or for a plain tensor, ``shard`` returns its argument: the one-card
path runs no DTensor op and keeps its bits.

``use_rules`` also turns on DTensor's implicit replication for its
duration: a plain tensor that meets a DTensor in an op (RoPE's angles, a
0-dim accumulator) counts as replicated over the mesh, the reference's
unsharded constants.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator

from repro_torch.distributed.sharding import MeshRules, axis_size, logical_mesh

_STATE: dict[str, Any] = {"mesh": None, "rules": None}

# kind -> logical axis per dim (None = replicated); 'model' entries fall
# back to replicated when the dim does not divide the model axes.  The
# reference's kinds of its chunked attention's carries (bqhgd, bhgqd, bhgq)
# have no counterpart: the port's attention is one kernel on each rank's
# heads (models/attention.py).
KINDS: dict[str, tuple[str | None, ...]] = {
    "btd": ("data", None, None),  # (batch, seq, d_model)
    "btf": ("data", None, "model"),  # (batch, seq, d_ff/d_inner)
    "bthd": ("data", None, "model", None),  # (batch, seq, heads, head_dim)
    "btv": ("data", None, "model"),  # logits (batch, seq, vocab)
    "bt": ("data", None),  # per-token scalars
    "gecd": ("data", "model", None, None),  # MoE capacity buffer (G,E,C,d)
    "bhpn": ("data", "model", None, None),  # SSM state (b, heads, p, n)
    "bshp": ("data", None, "model", None),  # SSD activations (b, s, heads, p)
}


def active() -> tuple[Any, MeshRules | None]:
    """The installed (mesh, rules), or (None, None)."""
    return _STATE["mesh"], _STATE["rules"]


@contextlib.contextmanager
def use_rules(mesh: Any, rules: MeshRules) -> Iterator[None]:
    """Install ``mesh`` (a ``DeviceMesh``) and ``rules`` for ``shard``, and
    DTensor's implicit replication of plain tensors, for the block."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["rules"] = rules
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.update(prev)


def spec_for(kind: str, shape: tuple[int, ...], mesh: Any, rules: MeshRules) -> tuple:
    """The mesh axes of each dim of a ``kind`` activation of ``shape``, the
    reference's resolution (trailing ``None`` dropped)."""
    axes = KINDS[kind]
    if len(axes) != len(shape):
        raise ValueError(f"kind {kind!r} has rank {len(axes)}, the tensor {tuple(shape)}")
    lm = logical_mesh(mesh)
    spec: list[Any] = []
    used: set[str] = set()
    for dim, name in zip(shape, axes):
        assignment = None
        if name in ("data", "model"):
            pool = rules.data_axes if name == "data" else rules.model_axes
            mesh_axes = tuple(a for a in pool if a not in used)
            if mesh_axes and dim % axis_size(lm, mesh_axes) == 0:
                assignment = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                used.update(mesh_axes)
        spec.append(assignment)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def placements(kind: str, shape: tuple[int, ...]) -> tuple | None:
    """The installed mesh's placements of a ``kind`` activation, or None
    without rules."""
    from repro_torch.distributed.sharding import placements_of

    mesh, rules = active()
    if mesh is None or rules is None:
        return None
    return placements_of(spec_for(kind, tuple(shape), mesh, rules), mesh)


def shard(x: Any, kind: str) -> Any:
    """``x`` at ``kind``'s placements on the installed mesh; ``x`` itself
    without rules or when ``x`` is not a DTensor."""
    mesh, rules = active()
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements(kind, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
