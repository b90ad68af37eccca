"""Uniform model API per architecture family, model inputs, and the carry
of reference weights (port of ``repro.models.registry``).

``registry.get(cfg)`` returns a :class:`ModelApi` with
spec/init/loss_fn/prefill/decode_step/init_state for every family of the
reference: the decoder-only transformers (dense, MoE, the VLM stub; GQA or
MLA attention, deepseek-v3's), the zamba hybrid (Mamba2 layers and one
shared attention block), the xLSTM stack (mLSTM and sLSTM blocks) and the
whisper encoder-decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import default_rules, distribute_tree, logical_mesh, whole
from repro_torch.models import common, transformer, whisper, xlstm_model, zamba


@dataclasses.dataclass(frozen=True)
class ModelApi:
    spec: Callable[..., Any]
    init: Callable[..., Any]
    loss_fn: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_state: Callable[..., Any]
    # the port's model from the reference's tree, and that tree's stacked keys
    from_tree: Callable[..., Any]
    stack_sizes: Callable[..., Any]


_TRANSFORMER = ModelApi(
    spec=transformer.spec,
    init=transformer.init,
    loss_fn=transformer.loss_fn,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    init_state=transformer.init_state,
    from_tree=transformer.from_tree,
    stack_sizes=transformer.stack_sizes,
)

_ZAMBA = ModelApi(
    spec=zamba.spec, init=zamba.init, loss_fn=zamba.loss_fn,
    prefill=zamba.prefill, decode_step=zamba.decode_step, init_state=zamba.init_state,
    from_tree=zamba.from_tree, stack_sizes=zamba.stack_sizes,
)

_XLSTM = ModelApi(
    spec=xlstm_model.spec, init=xlstm_model.init, loss_fn=xlstm_model.loss_fn,
    prefill=xlstm_model.prefill, decode_step=xlstm_model.decode_step,
    init_state=xlstm_model.init_state, from_tree=xlstm_model.from_tree,
    stack_sizes=xlstm_model.stack_sizes,
)

_WHISPER = ModelApi(
    spec=whisper.spec, init=whisper.init, loss_fn=whisper.loss_fn,
    prefill=whisper.prefill, decode_step=whisper.decode_step, init_state=whisper.init_state,
    from_tree=whisper.from_tree, stack_sizes=whisper.stack_sizes,
)


def get(cfg: ModelConfig) -> ModelApi:
    if cfg.is_encoder_decoder:
        return _WHISPER
    if cfg.hybrid_attn_every:
        return _ZAMBA
    if cfg.family == "ssm":
        return _XLSTM
    return _TRANSFORMER


def init_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None, *, mesh: Any = None,
    rules: sharding.MeshRules | None = None, kv_seq_shard: bool = False,
) -> Any:
    """``get(cfg).init_state`` on ``device``; with a ``mesh`` (a
    ``DeviceMesh``, at ``rules`` or the reference's defaults) the zero state
    placed by the reference's ``state_shardings`` rules
    (``distributed.sharding.distribute_state``; ``kv_seq_shard`` places the
    caches whose kv heads do not divide the model axes along their
    sequence), each rank allocating its own shard only."""
    api = get(cfg)
    if mesh is None:
        return api.init_state(cfg, batch, max_len, dtype, device)
    rules = rules or default_rules(logical_mesh(mesh))
    return sharding.distribute_state(api.init_state(cfg, batch, max_len, dtype, "meta"), mesh,
                                     rules, kv_seq_shard=kv_seq_shard)


def distribute_params(cfg: ModelConfig, params: common.ParamTree, mesh: Any,
                      rules: sharding.MeshRules | None = None) -> common.ParamTree:
    """The port's model ``params`` (whole, the same on every rank) as a new
    model of DTensors on ``mesh`` at the reference's ``param_placements``
    (``rules`` or the defaults): each per-layer leaf at its stacked leaf's
    placements without the layer dim.  Each rank keeps its shards; on a
    (1, 1) mesh a leaf keeps its storage."""
    rules = rules or default_rules(logical_mesh(mesh))
    placed = dict(common.tree_leaves(sharding.param_placements(get(cfg).spec(cfg), mesh, rules)))
    stacks = get(cfg).stack_sizes(cfg)
    tree: dict[str, Any] = {}
    for name, p in params.named_parameters():
        path = tuple(int(n) if n.isdigit() else n for n in name.split("."))
        if path[0] in stacks:
            pl = tuple(type(q)(q.dim - 1) if hasattr(q, "dim") else q
                       for q in placed[(path[0],) + path[2:]])
        else:
            pl = placed[path]
        common.tree_set(tree, path, sharding.distribute(p.detach(), mesh, pl))
    return common.ParamTree(tree)


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
    device: torch.device | str = "cpu", *, mesh: Any = None,
) -> common.ParamTree:
    """The port's model holding the reference's weights.

    Args:
        cfg: the architecture.
        tree: the reference's parameter tree (its family's ``init``'s
            nested dict) with numpy arrays at the leaves; the stacked
            leaves (``layers`` and ``moe_layers``, zamba's
            ``mamba_layers``, whisper's ``enc_layers`` and
            ``dec_layers``) are split per layer; xLSTM's ``blocks`` is a
            list in both trees.
        dtype: the port's parameter dtype; None keeps each array's dtype.
        device: where the port's parameters live.
        mesh: with a ``DeviceMesh``, every leaf becomes a DTensor on
            ``mesh`` at its ``distributed.sharding.param_placements`` under
            the reference's default rules (``device`` is then the mesh's);
            ``tree`` is the same on every rank.

    Raises:
        ValueError: when a leaf of the port's spec is missing from ``tree``
            or has another shape, or when ``tree`` has a leaf the spec does
            not know: every leaf is carried and none is left over.
    """
    want = dict(common.tree_leaves(get(cfg).spec(cfg)))
    have = dict(common.tree_leaves(tree))
    missing = sorted(common.path_name(p) for p in want.keys() - have.keys())
    extra = sorted(common.path_name(p) for p in have.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"{cfg.name}: reference tree and port spec differ: missing {missing}, "
                         f"left over {extra}")
    out: dict[str, Any] = {}
    for path, s in want.items():
        x = np.asarray(have[path])
        if tuple(x.shape) != s.shape:
            raise ValueError(f"{common.path_name(path)}: reference shape {x.shape}, port spec {s.shape}")
        t = torch.from_numpy(np.array(x))  # a writable copy
        t = t if mesh is not None else t.to(device=device)
        common.tree_set(out, path, t if dtype is None else t.to(dtype))
    if mesh is not None:
        out = distribute_tree(out, get(cfg).spec(cfg), mesh,
                              default_rules(logical_mesh(mesh)))
    return get(cfg).from_tree(cfg, out)


def params_to_reference(
    cfg: ModelConfig, params: torch.nn.Module | dict[str, torch.Tensor],
) -> dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the reference's tree
    (its family's ``spec``'s nested dicts and lists, each stack's per-layer
    leaves (``ModelApi.stack_sizes``) stacked over a leading layer dim in
    layer order) with numpy arrays at the leaves.

    Args:
        cfg: the architecture.
        params: the port's model, or a mapping from its parameter names
            (``named_parameters()``: ``"layers.3.attn.wq"``) to tensors,
            such as the gradients a train step returns.  bf16 leaves come
            out as f32 (numpy has no bf16); a DTensor leaf is gathered
            whole (a collective: every rank calls this).

    Raises:
        ValueError: when a name the spec needs is missing or one is left
            over.
    """
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
    out: dict[str, Any] = {}
    used = set()
    stacks = get(cfg).stack_sizes(cfg)
    for path, s in common.tree_leaves(get(cfg).spec(cfg)):
        stacked = path[0] in stacks
        if stacked:
            names = [common.path_name((path[0], i) + path[1:], ".")
                     for i in range(stacks[path[0]])]
        else:
            names = [common.path_name(path, ".")]
        missing = [n for n in names if n not in named]
        if missing:
            raise ValueError(f"{cfg.name}: no leaf named {missing[0]}")
        leaves = [whole(named[n]).to("cpu", torch.float32 if named[n].dtype == torch.bfloat16
                                       else named[n].dtype).numpy() for n in names]
        x = np.stack(leaves) if stacked else leaves[0]
        if tuple(x.shape) != s.shape:
            raise ValueError(f"{common.path_name(path)}: port shape {x.shape}, spec {s.shape}")
        common.tree_set(out, path, x)
        used.update(names)
    extra = sorted(set(named) - used)
    if extra:
        raise ValueError(f"{cfg.name}: leaves the spec does not know: {extra}")
    return out
