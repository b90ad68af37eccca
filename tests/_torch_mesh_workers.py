"""Ranks of the port's mesh tests: ``torch.multiprocessing.spawn`` processes
on gloo, rendezvous through a ``file://`` store, one CPU thread each.

This module imports torch and ``repro_torch`` only (never JAX), so a
spawned rank loads it without the reference.  Each rank function takes its
rank first and writes what the test reads to files: rank 0 writes the
results (``np.savez``), every rank joins every collective.

The training setting is the one of the reference's ``test_elastic_restart``:
``qwen3-4b.reduced()`` (f32), ``TokenPipeline(DataConfig(512, 32, 4,
seed=1))``, ``AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)``,
``q_chunk = kv_chunk = 8``, weights carried from the reference.
"""
from __future__ import annotations

import os
import pathlib
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
from repro_torch.distributed import act_sharding, sharding
from repro_torch.launch import mesh as meshes
from repro_torch.models import common, registry
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_grad_fn, make_train_step

ARCH = "qwen3-4b"
OPT = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
DATA = DataConfig(512, 32, 4, seed=1)
CHUNKS = {"q_chunk": 8, "kv_chunk": 8}
AXES = ("data", "model")
LEAF_TOL = 1e-4  # of a leaf's max: gradients, and leaves after AdamW steps
EMBED_TOL = 5e-4  # the tied embedding after AdamW: see test_torch_mesh_train.py


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, store, *args)`` on ``world`` gloo ranks and wait."""
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(fn, args=(os.path.join(d, "store"),) + args,
                                    nprocs=world, join=True)


def _start(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    meshes.init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=world)


def save_tree(path: str | pathlib.Path, tree: dict) -> None:
    """A reference-shaped tree of arrays as one ``.npz``, keyed by path."""
    np.savez(path, **{common.path_name(p): np.asarray(x) for p, x in common.tree_leaves(tree)})


def load_tree(path: str | pathlib.Path) -> dict:
    """:func:`save_tree`'s tree back: a digit in a path is a list index
    (xLSTM's ``blocks/0/...``)."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            common.tree_set(out, tuple(int(k) if k.isdigit() else k for k in key.split("/")),
                            z[key])
    return out


def max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_leaves_close(got: dict, want: dict, embed_tol: float = EMBED_TOL) -> None:
    """Every leaf within :data:`LEAF_TOL` of its max, the tied embedding
    within ``embed_tol`` (the gradients: :data:`LEAF_TOL` too)."""
    want_leaves = dict(common.tree_leaves(want))
    got_leaves = dict(common.tree_leaves(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        tol = embed_tol if path == ("embed",) else LEAF_TOL
        err = max_err(got_leaves[path], w)
        assert err <= tol, (common.path_name(path), err)


def _run(params, opt, pipe, pstate, cfg, steps: int, mesh=None, rules=None):
    """``steps`` train steps -> (params, opt, pstate, losses, grad norms,
    the first step's gradients as the reference's tree, gathered whole)."""
    step = make_train_step(cfg, OPT, **CHUNKS)
    losses, norms, grads = [], [], None
    for _ in range(steps):
        batch, pstate = make_train_batch(pipe, pstate, cfg)
        if mesh is not None:
            batch = sharding.distribute_batch(batch, mesh, rules)
        if grads is None:
            grads = registry.params_to_reference(cfg, make_grad_fn(cfg, **CHUNKS)(params,
                                                                                 batch)[0])
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, opt, pstate, losses, norms, grads


def train_one_process(init: dict, steps: int) -> dict:
    """The port's one-process run from the reference's weights: losses,
    grad norms, the first step's gradients and every leaf after ``steps``
    (the reference's trees)."""
    cfg = get_config(ARCH).reduced()
    params = common.trainable(registry.params_from_reference(cfg, init))
    opt = adamw.init(params, OPT)
    params, opt, _, losses, norms, grads = _run(params, opt, TokenPipeline(DATA),
                                                PipelineState(), cfg, steps)
    return {"losses": losses, "grad_norms": norms, "grads": grads,
            "params": registry.params_to_reference(cfg, params)}


def train_rank(rank: int, store: str, world: int, shape: tuple[int, int], init_path: str,
               steps: int, out_path: str, save_dir: str | None = None,
               restore_dir: str | None = None) -> None:
    """One rank of a mesh run of ``shape``: weights from ``init_path`` (or,
    with ``restore_dir``, the newest checkpoint there, onto this mesh),
    ``steps`` steps, then (with ``save_dir``) a checkpoint.  Rank 0 writes
    the losses, grad norms, the pipeline step, the first step's gradients
    (``out_path``.grads.npz) and every leaf (``out_path``.params.npz), all
    whole."""
    _start(rank, world, store)
    try:
        mesh = meshes.make_mesh(shape, AXES, device="cpu")
        rules = sharding.default_rules(sharding.logical_mesh(mesh))
        cfg = get_config(ARCH).reduced()
        params = common.trainable(registry.params_from_reference(cfg, load_tree(init_path),
                                                                 mesh=mesh))
        opt = adamw.init(params, OPT)
        pstate = PipelineState()
        if restore_dir:
            mgr = CheckpointManager(CheckpointConfig(restore_dir))
            _, extra, _ = mgr.restore((params, opt))
            pstate = PipelineState(step=int(extra["pipeline_step"]))
        with act_sharding.use_rules(mesh, rules):
            params, opt, pstate, losses, norms, grads = _run(
                params, opt, TokenPipeline(DATA), pstate, cfg, steps, mesh, rules)
        if save_dir:
            mgr = CheckpointManager(CheckpointConfig(save_dir))
            mgr.save(pstate.step, (params, opt), {"pipeline_step": pstate.step,
                                                  "loss": losses[-1]})
            mgr.wait()
        tree = registry.params_to_reference(cfg, params)
        placements = {n: str(tuple(p.placements)) for n, p in params.named_parameters()}
        if rank == 0:
            save_tree(out_path + ".params.npz", tree)
            save_tree(out_path + ".grads.npz", grads)
            np.savez(out_path, losses=np.array(losses), grad_norms=np.array(norms),
                     pipeline_step=pstate.step, count=int(opt["count"]),
                     placements=np.array(sorted(placements.items())))
    finally:
        torch.distributed.destroy_process_group()


# (label, mesh shape, hq, hkv): the model axis at 4 with kv heads that
# shard with q's, that do not (one kv head for a rank's query heads, a
# slice of several), MQA, and a rank whose query heads straddle groups
ATTENTION_CASES = [
    ("kv sharded", (1, 4), 8, 4),
    ("one kv head a rank", (1, 4), 8, 2),
    ("kv slice", (2, 2), 8, 2),
    ("mqa", (1, 4), 4, 1),
    ("straddling groups", (2, 2), 6, 3),
    ("data only", (4, 1), 4, 2),
]


def attention_rank(rank: int, store: str, world: int, out_path: str) -> None:
    """The flash attention on DTensors (``models.attention.flash_attention``
    under rules) forward and backward at every case of
    :data:`ATTENTION_CASES`, gathered whole; rank 0 writes out, dq, dk, dv
    and, per case, whether k and v were sharded over the model axis."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import attention

    _start(rank, world, store)
    results = {}
    try:
        for label, shape, hq, hkv in ATTENTION_CASES:
            mesh = meshes.make_mesh(shape, AXES, device="cpu")
            rules = sharding.default_rules(sharding.logical_mesh(mesh))
            q, k, v, dout = attention_inputs(hq, hkv)
            with act_sharding.use_rules(mesh, rules):
                dts = [sharding.distribute(t, mesh, act_sharding.placements("bthd", t.shape))
                       for t in (q, k, v, dout)]
                leaves = [t.requires_grad_() for t in dts[:3]]
                out = attention.flash_attention(*leaves, causal=True, q_chunk=8, kv_chunk=8)
                out.backward(dts[3])
            results[label + "/out"] = sharding.whole(out).numpy()
            for name, t in zip("qkv", leaves):
                results[f"{label}/d{name}"] = sharding.whole(t.grad).numpy()
            results[label + "/kv_sharded"] = np.array(Shard(2) in dts[1].placements)
        if rank == 0:
            np.savez(out_path, **results)
    finally:
        torch.distributed.destroy_process_group()


def attention_inputs(hq: int, hkv: int, b: int = 4, s: int = 24, d: int = 16):
    rng = np.random.default_rng(hq * 10 + hkv)
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)) for sh in shapes]


# The reference's run on its (2, 2) mesh over 4 forced CPU devices, as its
# own tests/test_elastic_restart.py trains: run by conftest's
# run_forced_device_subprocess after .format(steps=..., keep=..., out=...).
# It writes the initial weights (``out``.init.npz), the first step's
# gradients (``out``.grads.npz) and the weights after step ``keep``
# (``out``.params.npz), and prints the losses and grad norms.
REFERENCE_RUN = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro import compat
from repro.configs import get_config
from repro.models import registry
from repro.distributed import sharding
from repro.launch.mesh import make_mesh
from repro.optim import adamw
from repro.train.train_step import make_loss_fn, make_train_step
from repro.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch

def save(path, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(path, **{{"/".join(str(k.key) for k in p): np.asarray(x) for p, x in flat}})

cfg = get_config("qwen3-4b").reduced()
mesh = make_mesh((2, 2), ("data", "model"))
rules = sharding.default_rules(mesh)
api = registry.get(cfg)
p_sh = sharding.param_shardings(api.spec(cfg), mesh, rules)
losses, norms = [], []
with compat.set_mesh(mesh):
    params = api.init(jax.random.PRNGKey(0), cfg)
    save({out!r} + ".init.npz", params)
    params = jax.tree.map(jax.device_put, params, p_sh)
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    opt = adamw.init(params, opt_cfg)
    step = jax.jit(make_train_step(cfg, opt_cfg, q_chunk=8, kv_chunk=8))
    grad = jax.jit(jax.grad(make_loss_fn(cfg, q_chunk=8, kv_chunk=8), has_aux=True))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4, seed=1))
    pstate = PipelineState()
    for i in range({steps}):
        batch, pstate = make_train_batch(pipe, pstate, cfg)
        if i == 0:
            save({out!r} + ".grads.npz", grad(params, batch)[0])
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i + 1 == {keep}:
            save({out!r} + ".params.npz", params)
    assert params["embed"].sharding.spec == p_sh["embed"].spec
print(json.dumps({{"losses": losses, "grad_norms": norms, "devices": len(jax.devices()),
                  "embed_spec": str(p_sh["embed"].spec)}}))
"""
