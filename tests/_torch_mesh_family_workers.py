"""Ranks of the port's mesh tests of whole families (training and serving,
on caches split along their sequence too): ``torch.multiprocessing.spawn``
processes on gloo (see
``_torch_mesh_workers``), and the reference's runs on its forced 4-device
CPU meshes, as code for ``conftest.run_forced_device_subprocess``.

This module imports torch and ``repro_torch`` only (never JAX).  Each rank
function takes its rank first; every rank joins every collective and
writes its own files (its routes, its local cache sizes), rank 0 the
results gathered whole.

Training: ``TRAIN_ARCHS`` reduced (f32), the setting of
``_torch_mesh_workers`` (``DataConfig(512, 32, 4, seed=1)``, the AdamW
config, chunks of 8), 3 steps from the reference's weights (an
encoder-decoder's frames the port's: :func:`train_frames`).  Serving:
``SERVE_ARCHS`` reduced (f32 weights and caches), ``SERVE_BATCH`` prompts
of ``SERVE_PROMPT`` tokens (and :func:`serve_extras`), prefill and
``SERVE_STEPS`` greedy decode steps in caches of ``SERVE_MAX_LEN``.  Any
other family runs the same way by its name or a :data:`VARIANTS` label
(:func:`reduced`).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from _torch_mesh_workers import (AXES, CHUNKS, DATA, OPT, _start, load_tree, save_tree)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineState, TokenPipeline, make_train_batch
from repro_torch.distributed import act_sharding, sharding
from repro_torch.launch import mesh as meshes
from repro_torch.models import common, moe, registry
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train.train_step import make_grad_fn, make_train_step

# label -> (registry name, fields replaced on its reduced config): whisper-tiny
# with its own 6 heads, which do not divide a model axis of 4
VARIANTS = {"whisper-tiny-6h": ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6})}

TRAIN_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
TRAIN_MESHES = ((2, 2), (1, 4))
STEPS = 3
SERVE_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m", "deepseek-v3-671b")
SERVE_MESH = (2, 2)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 4, 16, 4, 24
METRICS = ("loss", "nll", "aux", "mtp_nll", "grad_norm")


INIT_STD = 0.05


def reduced(arch: str):
    """``arch``'s reduced config, or a :data:`VARIANTS` label's."""
    base, fields = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(get_config(base).reduced(), **fields)


def init_tree(arch: str, seed: int = 0) -> dict:
    """The reduced ``arch``'s weights as the reference's tree of numpy
    arrays: zeros, ones, or ``scale * N(0, 1)`` with the spec's scale, else
    :data:`INIT_STD` (``test_torch_moe.py``'s carry).  The reference's own
    init takes 1/sqrt(shape[0]), the layer count of a stacked leaf: std
    0.5 here, which saturates the MoE layers and amplifies f32 rounding so
    far that the reference's own (2, 2) and (1, 4) runs part by 3.3e-4 of
    a first gradient's max and 1.6e-2 of the router's after 3 steps."""
    cfg = reduced(arch)
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(registry.get(cfg).spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = (rng.standard_normal(s.shape) * (s.scale or INIT_STD)).astype(np.float32)
        common.tree_set(tree, path, x)
    return tree


def train_frames(arch: str) -> list[np.ndarray]:
    """The port's frames of each of the ``STEPS`` training batches of an
    encoder-decoder ``arch`` (``make_train_batch``'s, which the reference's
    run takes in place of its own draws); [] for any other arch."""
    cfg = reduced(arch)
    if not cfg.is_encoder_decoder:
        return []
    pipe, pstate, out = TokenPipeline(DATA), PipelineState(), []
    for _ in range(STEPS):
        batch, pstate = make_train_batch(pipe, pstate, cfg)
        out.append(batch["frames"].numpy())
    return out


def tag(out_dir: str, arch: str, shape: tuple[int, ...]) -> str:
    """The files' stem of one (arch, mesh) run."""
    return os.path.join(out_dir, f"{arch}_{'x'.join(map(str, shape))}")


class RouteRecorder:
    """Wraps ``moe._route_parts`` while on: appends each call's expert ids
    (the rank's own groups on a mesh) to ``routes``."""

    def __init__(self):
        self.routes: list[np.ndarray] = []
        self.on = False
        self._inner = moe._route_parts

    def __enter__(self):
        def recording(params, x, cfg):
            out = self._inner(params, x, cfg)
            if self.on:
                self.routes.append(out[1].detach().cpu().numpy())
            return out

        moe._route_parts = recording
        return self

    def __exit__(self, *exc):
        moe._route_parts = self._inner


def n_moe_layers(cfg) -> int:
    return registry.get(cfg).stack_sizes(cfg).get("moe_layers", 0)


def _train(cfg, params, mesh=None, rules=None):
    """3 steps from ``params``: (metrics per step, the first step's
    gradients as the reference's tree, the first forward's routes)."""
    step = make_train_step(cfg, OPT, **CHUNKS)
    opt = adamw.init(params, OPT)
    pipe, pstate = TokenPipeline(DATA), PipelineState()
    metrics, grads = [], None
    with RouteRecorder() as rec:
        for i in range(STEPS):
            batch, pstate = make_train_batch(pipe, pstate, cfg)
            if mesh is not None:
                batch = sharding.distribute_batch(batch, mesh, rules)
            if i == 0:
                rec.on = True
                grads = registry.params_to_reference(cfg, make_grad_fn(cfg, **CHUNKS)(params,
                                                                                     batch)[0])
                rec.on = False
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(m[k]) for k in METRICS if k in m})
    return params, opt, metrics, grads, rec.routes[:n_moe_layers(cfg)]


def train_one_process(arch: str, init_path: str, out_stem: str) -> None:
    """The port's one-process run of ``arch`` from the weights at
    ``init_path``, on one CPU thread as the ranks run; writes what
    :func:`train_rank` writes, under ``out_stem``."""
    cfg = reduced(arch)
    params = common.trainable(registry.params_from_reference(cfg, load_tree(init_path)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, _, metrics, grads, routes = _train(cfg, params)
    finally:
        torch.set_num_threads(threads)
    _write(out_stem, cfg, params, metrics, grads, {})
    np.savez(out_stem + ".routes.rank0.npz", *routes)


def _write(stem: str, cfg, params, metrics, grads, placements) -> None:
    save_tree(stem + ".params.npz", registry.params_to_reference(cfg, params))
    save_tree(stem + ".grads.npz", grads)
    with open(stem + ".json", "w") as f:
        json.dump({"metrics": metrics, "placements": placements}, f)


def train_rank(rank: int, store: str, world: int, runs: list, init_dir: str,
               out_dir: str) -> None:
    """One rank of each (arch, mesh shape) of ``runs``, in order, on one
    process group: weights from ``init_dir`` (``{arch}.init.npz``), 3 steps.
    Every rank writes its routes (``.routes.rank{r}.npz``: its groups);
    rank 0 the metrics, the parameters' placements, the first step's
    gradients and every leaf after the steps, all whole."""
    _start(rank, world, store)
    try:
        for arch, shape in runs:
            mesh = meshes.make_mesh(tuple(shape), AXES, device="cpu")
            rules = sharding.default_rules(sharding.logical_mesh(mesh))
            cfg = reduced(arch)
            init = load_tree(os.path.join(init_dir, arch + ".init.npz"))
            params = common.trainable(registry.params_from_reference(cfg, init, mesh=mesh))
            with act_sharding.use_rules(mesh, rules):
                params, _, metrics, grads, routes = _train(cfg, params, mesh, rules)
            stem = tag(out_dir, arch, shape)
            np.savez(stem + f".routes.rank{rank}.npz", *routes)
            placements = {n: str(tuple(p.placements)) for n, p in params.named_parameters()}
            tree = registry.params_to_reference(cfg, params)
            if rank == 0:
                save_tree(stem + ".params.npz", tree)
                save_tree(stem + ".grads.npz", grads)
                with open(stem + ".json", "w") as f:
                    json.dump({"metrics": metrics, "placements": placements}, f)
    finally:
        torch.distributed.destroy_process_group()


def serve_prompts(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                                             dtype=np.int32)


def serve_extras(cfg) -> dict[str, np.ndarray]:
    """An encoder-decoder's prefill frames (f32, the reference script's
    draw); none for any other family."""
    if not cfg.is_encoder_decoder:
        return {}
    return {"frames": np.random.default_rng(8).standard_normal(
        (SERVE_BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32)}


def seq_tag(out_dir: str, arch: str, shape: tuple[int, ...], kv_seq_shard: bool) -> str:
    """:func:`tag`, with ``_seq`` after the shape for a ``kv_seq_shard`` run."""
    return tag(out_dir, arch, shape) + ("_seq" if kv_seq_shard else "")


def _serve(engine: ServeEngine, prompts: np.ndarray):
    """Prefill and ``SERVE_STEPS`` greedy decode steps through the engine's
    calls: (the logits of each call gathered whole (B, V), the tokens
    (B, SERVE_STEPS + 1), the state after the last step)."""
    state = engine.init_state(prompts.shape[0])
    toks = torch.from_numpy(prompts).to(engine.device)
    extras = {k: torch.from_numpy(v).to(engine.device) for k, v in serve_extras(engine.cfg).items()}
    logits, state = engine.prefill({"tokens": toks, **extras}, state)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    out_logits, out_toks = [], []
    for t in range(SERVE_STEPS + 1):
        out_logits.append(sharding.whole(logits)[:, -1].float().cpu().numpy())
        tok = engine._next(logits, gen)
        out_toks.append(tok.cpu().numpy())
        if t < SERVE_STEPS:
            logits, state = engine.decode(tok, state, SERVE_PROMPT + t)
    return np.stack(out_logits), np.concatenate(out_toks, axis=1), state


def serve_one_process(arch: str, init_path: str) -> dict:
    """The port's one-process serving of ``arch``: logits and tokens."""
    cfg = reduced(arch)
    params = registry.params_from_reference(cfg, load_tree(init_path))
    engine = ServeEngine(cfg, params, ServeConfig(max_len=SERVE_MAX_LEN), device="cpu")
    logits, toks, _ = _serve(engine, serve_prompts(cfg))
    return {"logits": logits, "tokens": toks}


def serve_rank(rank: int, store: str, world: int, archs: list, shape: tuple, init_dir: str,
               out_dir: str, kv_seq_shard: bool = False) -> None:
    """One rank serving each arch of ``archs`` on a ``shape`` mesh through
    ``ServeEngine(..., mesh=, kv_seq_shard=)``, weights from ``init_dir``
    (``{arch}.init.npz``): rank 0 writes the logits, tokens and
    ``generate``'s tokens; every rank writes each cache leaf's placements
    and its local element count (``.cache.rank{r}.json``), under
    :func:`seq_tag`."""
    _start(rank, world, store)
    try:
        mesh = meshes.make_mesh(tuple(shape), AXES, device="cpu")
        for arch in archs:
            cfg = reduced(arch)
            params = registry.params_from_reference(cfg, load_tree(
                os.path.join(init_dir, arch + ".init.npz")))
            engine = ServeEngine(cfg, params, ServeConfig(max_len=SERVE_MAX_LEN), mesh=mesh,
                                 kv_seq_shard=kv_seq_shard)
            prompts = serve_prompts(cfg)
            logits, toks, state = _serve(engine, prompts)
            generated = engine.generate(prompts, SERVE_STEPS + 1, serve_extras(cfg))
            cache = {common.path_name(p): {"placements": str(tuple(x.placements)),
                                           "shape": list(x.shape),
                                           "local_numel": x.to_local().numel()}
                     for p, x in common.tree_leaves(state)}
            stem = seq_tag(out_dir, arch, shape, kv_seq_shard)
            with open(stem + f".cache.rank{rank}.json", "w") as f:
                json.dump(cache, f)
            if rank == 0:
                np.savez(stem + ".serve.npz", logits=logits, tokens=toks, generated=generated)
    finally:
        torch.distributed.destroy_process_group()


# The scripts' ``reduced(arch)``: :func:`reduced` on the reference's configs
# (doubled braces: the scripts are ``str.format`` templates).
_REDUCED = ("import dataclasses\nVARIANTS = " + repr(VARIANTS).replace("{", "{{").replace("}", "}}")
            + "\n\ndef reduced(arch):\n    base, fields = VARIANTS.get(arch, (arch, {{}}))\n"
            "    return dataclasses.replace(get_config(base).reduced(), **fields)\n\n"
            "def listed(node):\n"
            "    # a dict keyed by list indices (xLSTM's blocks) as the list\n"
            "    if not isinstance(node, dict):\n        return node\n"
            "    node = {{k: listed(v) for k, v in node.items()}}\n"
            "    if node and all(k.isdigit() for k in node):\n"
            "        return [node[str(i)] for i in range(len(node))]\n"
            "    return node\n")

# The reference's training on its forced 4-device meshes, as its lower_cell
# builds the step: ``make_train_step(..., param_shardings=p_sh)`` jitted with
# ``in_shardings=(p_sh, opt_sh, b_sh)``, ``out_shardings=(p_sh, opt_sh,
# None)``, under ``set_mesh`` and ``act_sharding.use_rules``.  Formatted
# with ``runs`` ([(arch, shape)]) and ``out`` (a directory holding each
# arch's weights, ``{arch}.init.npz``: :func:`init_tree`).  Per run it
# writes AdamW's first moment after step
# 1 (.m1.npz: 0.1 x the clipped first gradient), every leaf after the steps
# (.params.npz) and the first forward's expert ids per MoE layer
# (.routes.npz, through ``jax.debug.callback`` in ``moe._route``); it
# prints the metrics and the parameters' specs.
REFERENCE_TRAIN = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro import compat
from repro.configs import get_config
from repro.models import registry, moe
from repro.distributed import sharding, act_sharding
from repro.launch.mesh import make_mesh
from repro.optim import adamw
from repro.train.train_step import make_train_step
from repro.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
""" + _REDUCED + r"""
def save(path, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(path, **{{"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p):
                      np.asarray(x) for p, x in flat}})

def load(path):
    tree = {{}}
    with np.load(path) as z:
        for name in z.files:
            *head, last = name.split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {{}})
            node[last] = jax.numpy.asarray(z[name])
    return listed(tree)

out = {{}}
inner = moe._route
for arch, shape in {runs!r}:
    cfg = reduced(arch)
    mesh = make_mesh(tuple(shape), ("data", "model"))
    rules = sharding.default_rules(mesh)
    api = registry.get(cfg)
    p_sh = sharding.param_shardings(api.spec(cfg), mesh, rules)
    opt_sh = sharding.opt_state_shardings(p_sh, mesh)
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    pipe, pstate = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4, seed=1)), PipelineState()
    stem = os.path.join({out!r}, arch + "_" + "x".join(map(str, shape)))
    routes, recording = [], [True]

    def route(params, x, c):
        w, idx, aux = inner(params, x, c)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)) if recording[0] else None, idx)
        return w, idx, aux

    metrics = []
    with compat.set_mesh(mesh), act_sharding.use_rules(mesh, rules):
        params = jax.device_put(load(os.path.join({out!r}, arch + ".init.npz")), p_sh)
        opt = jax.device_put(adamw.init(params, opt_cfg), opt_sh)
        b0, _ = make_train_batch(pipe, pstate, cfg)
        b_sh = sharding.batch_shardings(
            {{k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b0.items()}}, mesh, rules)
        moe._route = route
        step = jax.jit(make_train_step(cfg, opt_cfg, param_shardings=p_sh, q_chunk=8, kv_chunk=8),
                       in_shardings=(p_sh, opt_sh, b_sh), out_shardings=(p_sh, opt_sh, None))
        frames = os.path.join({out!r}, arch + ".frames.npz")
        for i in range({steps}):
            batch, pstate = make_train_batch(pipe, pstate, cfg)
            if os.path.exists(frames):  # the port's frames (train_frames)
                with np.load(frames) as z:
                    batch["frames"] = jax.numpy.asarray(z[f"arr_{{i}}"])
            params, opt, m = step(params, opt, batch)
            jax.block_until_ready(params)
            recording[0] = False
            if i == 0:
                save(stem + ".m1.npz", opt["m"])
            metrics.append({{k: float(v) for k, v in m.items()}})
        moe._route = inner
        save(stem + ".params.npz", params)
    n_moe = cfg.n_layers - (cfg.n_dense_layers if cfg.is_moe else cfg.n_layers)
    np.savez(stem + ".routes.npz", *routes[:n_moe])  # the forward's; the rest recompute
    specs = {{"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p):
              [list(e) if isinstance(e, tuple) else e
                                               for e in s.spec]
             for p, s in jax.tree_util.tree_flatten_with_path(p_sh)[0]}}
    out[stem] = {{"metrics": metrics, "specs": specs, "devices": len(jax.devices())}}
print(json.dumps(out))
"""

# The reference's prefill and decode on its forced 4-device mesh, as its
# lower_cell builds them (dryrun.py): ``api.prefill`` jitted with
# ``in_shardings=(p_sh, b_sh, s_sh)``, ``out_shardings=(None, s_sh)``,
# ``api.decode_step`` with ``(p_sh, b_sh, s_sh, None)``, the state from
# ``state_shardings`` (``kv_seq_shard`` as formatted), f32 caches.
# Formatted with ``archs``, ``shape``, ``out`` (a directory holding each
# arch's weights, ``{arch}.init.npz``), ``kv_seq_shard``, ``suffix`` (the
# files' stem after the shape: :func:`tag`'s) and the serving constants; an
# encoder-decoder prefills on :func:`serve_frames`; per arch it writes the logits and greedy
# tokens (.ref_serve.npz), and prints each state leaf's spec and the
# state's shardings after the last step.
REFERENCE_SERVE = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro import compat
from repro.configs import get_config
from repro.models import registry
from repro.distributed import sharding, act_sharding
from repro.launch.mesh import make_mesh
""" + _REDUCED + r"""
def key(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p)

def load(path):
    tree = {{}}
    with np.load(path) as z:
        for name in z.files:
            *head, last = name.split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {{}})
            node[last] = jnp.asarray(z[name])
    return listed(tree)

out = {{}}
mesh = make_mesh({shape!r}, ("data", "model"))
rules = sharding.default_rules(mesh)
for arch in {archs!r}:
    cfg = reduced(arch)
    api = registry.get(cfg)
    p_sh = sharding.param_shardings(api.spec(cfg), mesh, rules)
    stem = os.path.join({out!r}, arch + "_" + "x".join(map(str, {shape!r})) + {suffix!r})
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, ({batch}, {prompt}),
                                                dtype=np.int32)
    with compat.set_mesh(mesh), act_sharding.use_rules(mesh, rules):
        params = jax.device_put(load(os.path.join({out!r}, arch + ".init.npz")), p_sh)
        state_sds = api.state_spec(cfg, {batch}, {max_len}, jnp.float32)
        s_sh = sharding.state_shardings(state_sds, mesh, rules, kv_seq_shard={kv_seq_shard})
        state = jax.device_put(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), state_sds),
                               s_sh)
        def b_sh(batch):
            return sharding.batch_shardings(
                {{k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}}, mesh,
                rules)
        pre = {{"tokens": jnp.asarray(prompts)}}
        if cfg.is_encoder_decoder:  # serve_frames
            pre["frames"] = jnp.asarray(np.random.default_rng(8).standard_normal(
                ({batch}, cfg.encoder_len, cfg.d_model)).astype(np.float32))
        prefill = jax.jit(lambda p, b, s: api.prefill(p, b, s, cfg),
                          in_shardings=(p_sh, b_sh(pre), s_sh), out_shardings=(None, s_sh))
        one = {{"tokens": jnp.zeros(({batch}, 1), jnp.int32)}}
        decode = jax.jit(lambda p, b, s, c: api.decode_step(p, b, s, c, cfg),
                         in_shardings=(p_sh, b_sh(one), s_sh, None), out_shardings=(None, s_sh))
        logits, state = prefill(params, pre, state)
        all_logits, toks = [], []
        for t in range({steps} + 1):
            lg = np.asarray(logits, np.float32)[:, -1]
            all_logits.append(lg)
            tok = lg.argmax(-1).astype(np.int32)[:, None]
            toks.append(tok)
            if t < {steps}:
                logits, state = decode(params, {{"tokens": jnp.asarray(tok)}}, state,
                                       jnp.int32({prompt} + t))
        np.savez(stem + ".ref_serve.npz", logits=np.stack(all_logits),
                 tokens=np.concatenate(toks, axis=1))
    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    out[stem] = {{
        "state_specs": {{key(p): spec(s) for p, s in
                        jax.tree_util.tree_flatten_with_path(s_sh)[0]}},
        "state_out": {{key(p): spec(x.sharding) for p, x in
                      jax.tree_util.tree_flatten_with_path(state)[0]}}}}
print(json.dumps(out))
"""


# (S, start, rows) writes into a (B, S, H, D) cache split along S over 4 ranks
# (S / 4 rows each): inside one rank's range, across two and three ranks'
# boundaries, one row at a rank's last and first, all of it
SEQ_WRITES = [(16, 1, 2), (16, 3, 2), (16, 2, 11), (16, 7, 1), (16, 8, 1), (16, 0, 16)]


def seq_cache_rank(rank: int, store: str, world: int, out_path: str) -> None:
    """``models.attention.write_cache`` into caches split along their
    sequence over a (1, world) mesh, for each of :data:`SEQ_WRITES`: every
    rank writes its local shard and records it, gathered here only to be
    checked (rank 0 writes ``out_path``: each case's shards in rank order
    and the whole cache a plain write gives)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import attention

    _start(rank, world, store)
    try:
        mesh = meshes.make_mesh((1, world), AXES, device="cpu")
        out = {}
        for i, (s, start, rows) in enumerate(SEQ_WRITES):
            rng = np.random.default_rng(i)
            new = torch.from_numpy(rng.standard_normal((2, rows, 1, 4), dtype=np.float32))
            cache = sharding.distribute(torch.zeros(2, s, 1, 4), mesh, (Replicate(), Shard(1)))
            attention.write_cache(cache, sharding.distribute(new, mesh, (Replicate(),) * 2),
                                  start)
            local = cache.to_local().clone()
            parts = [torch.empty_like(local) for _ in range(world)]
            torch.distributed.all_gather(parts, local)
            want = torch.zeros(2, s, 1, 4)
            attention.write_cache(want, new, start)
            out[f"{i}/shards"] = torch.cat(parts, dim=1).numpy()
            out[f"{i}/want"] = want.numpy()
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()
