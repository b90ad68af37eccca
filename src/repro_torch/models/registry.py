"""Uniform model API per architecture family, model inputs, and the carry
of reference weights (port of ``repro.models.registry``).

``registry.get(cfg)`` returns a :class:`ModelApi` with
spec/init/loss_fn/prefill/decode_step/init_state.  The decoder-only
transformer families (dense, MoE, the VLM stub) are served and trained;
MLA attention (deepseek-v3), whisper, zamba and xlstm raise, naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import common, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    spec: Callable[..., Any]
    init: Callable[..., Any]
    loss_fn: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_state: Callable[..., Any]


_TRANSFORMER = ModelApi(
    spec=transformer.spec,
    init=transformer.init,
    loss_fn=transformer.loss_fn,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    init_state=transformer.init_state,
)

_LATER = "is not ported yet (ROADMAP Queue 1, the hybrid, SSM and whisper item)"


def get(cfg: ModelConfig) -> ModelApi:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the whisper encoder-decoder {_LATER}")
    if cfg.hybrid_attn_every:
        raise NotImplementedError(f"{cfg.name}: the zamba hybrid {_LATER}")
    if cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: the xlstm family {_LATER}")
    return _TRANSFORMER


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every model input of an (arch x shape) cell.

    train:   {tokens, labels, (labels2), (patches), (frames)} full seq_len
    prefill: {tokens, (patches), (frames)} full seq_len (cache written)
    decode:  {tokens (B,1)} — the KV cache comes from init_state.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    emb = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        specs: dict[str, Any] = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        if cfg.mtp_depth:
            specs["labels2"] = ((b, s), i32)
    elif shape.kind == "prefill":
        specs = {"tokens": ((b, s), i32)}
    else:  # decode
        specs = {"tokens": ((b, 1), i32)}
    if cfg.n_patches and shape.kind != "decode":
        specs["patches"] = ((b, cfg.n_patches, cfg.d_model), emb)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        specs["frames"] = ((b, cfg.encoder_len, cfg.d_model), emb)
    return specs


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random inputs matching :func:`input_specs`, on the generator's device
    (torch's numbers, not ``jax.random``'s)."""
    dev = generator.device
    out: dict[str, torch.Tensor] = {}
    for name, (shp, dtype) in sorted(input_specs(cfg, shape).items()):
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=generator,
                                      dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(shp, generator=generator, device=dev).to(dtype)
    return out


def params_from_reference(
    cfg: ModelConfig, tree: dict[str, Any], dtype: torch.dtype | None = None,
    device: torch.device | str = "cpu",
) -> common.ParamTree:
    """The port's model holding the reference's weights.

    Args:
        cfg: the architecture.
        tree: the reference's parameter tree (``transformer.init``'s nested
            dict) with numpy arrays at the leaves; the stacked ``layers``
            and ``moe_layers`` leaves are split per layer.
        dtype: the port's parameter dtype; None keeps each array's dtype.
        device: where the port's parameters live.

    Raises:
        ValueError: when a leaf of the port's spec is missing from ``tree``
            or has another shape, or when ``tree`` has a leaf the spec does
            not know: every leaf is carried and none is left over.
    """
    want = dict(common.tree_leaves(get(cfg).spec(cfg)))
    have = dict(common.tree_leaves(tree))
    missing = sorted("/".join(p) for p in want.keys() - have.keys())
    extra = sorted("/".join(p) for p in have.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"{cfg.name}: reference tree and port spec differ: missing {missing}, "
                         f"left over {extra}")
    out: dict[str, Any] = {}
    for path, s in want.items():
        x = np.asarray(have[path])
        if tuple(x.shape) != s.shape:
            raise ValueError(f"{'/'.join(path)}: reference shape {x.shape}, port spec {s.shape}")
        t = torch.from_numpy(np.array(x)).to(device=device)  # a writable copy
        common.tree_set(out, path, t if dtype is None else t.to(dtype))
    return transformer.from_tree(cfg, out)


def params_to_reference(
    cfg: ModelConfig, params: torch.nn.Module | dict[str, torch.Tensor],
) -> dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the reference's tree
    (``transformer.spec``'s nested dict, each stack's per-layer leaves,
    ``layers`` and ``moe_layers``, stacked over a leading layer dim in
    layer order) with numpy arrays at the leaves.

    Args:
        cfg: the architecture.
        params: the port's model, or a mapping from its parameter names
            (``named_parameters()``: ``"layers.3.attn.wq"``) to tensors,
            such as the gradients a train step returns.  bf16 leaves come
            out as f32 (numpy has no bf16).

    Raises:
        ValueError: when a name the spec needs is missing or one is left
            over.
    """
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
    out: dict[str, Any] = {}
    used = set()
    stacks = transformer.stack_sizes(cfg)
    for path, s in common.tree_leaves(get(cfg).spec(cfg)):
        stacked = path[0] in stacks
        if stacked:
            names = [".".join((path[0], str(i)) + path[1:]) for i in range(stacks[path[0]])]
        else:
            names = [".".join(path)]
        missing = [n for n in names if n not in named]
        if missing:
            raise ValueError(f"{cfg.name}: no leaf named {missing[0]}")
        leaves = [named[n].detach().to("cpu", torch.float32 if named[n].dtype == torch.bfloat16
                                       else named[n].dtype).numpy() for n in names]
        x = np.stack(leaves) if stacked else leaves[0]
        if tuple(x.shape) != s.shape:
            raise ValueError(f"{'/'.join(path)}: port shape {x.shape}, spec {s.shape}")
        common.tree_set(out, path, x)
        used.update(names)
    extra = sorted(set(named) - used)
    if extra:
        raise ValueError(f"{cfg.name}: leaves the spec does not know: {extra}")
    return out
