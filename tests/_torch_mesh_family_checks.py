"""The runs and checks of the port's mesh tests of whole families, against
the reference's jitted step, prefill and decode on its forced 4-device
CPU meshes (``_torch_mesh_family_workers``'s scripts), against the port's
one process, and on a (1, 1) gloo mesh bitwise against that process.

Imports numpy, torch and ``repro_torch`` (never JAX): the reference runs in
its own interpreter (``conftest.run_forced_device_subprocess``).

Tolerances are ``test_torch_mesh_families.py``'s: each loss (and its nll,
aux and mtp_nll) within 1e-4 relative, the grad norm 1e-3, the first step's
gradients leaf by leaf within ``LEAF_TOL`` of each leaf's max, every leaf
after 3 steps within ``LEAF_TOL`` (the tied embedding ``EMBED_TOL``), each
served call's last-position logits within 1e-4 of their max, the greedy
tokens equal.  A leaf whose exact gradient is zero holds rounding noise on
both sides, so its error is taken against the larger of its max and
``LEAF_TOL`` of the tree's largest (the rule of ``test_torch_xlstm.py``):
xLSTM's input-gate biases (:func:`noise_leaves`).

Two families' leaves after the 3 AdamW steps are held above ``LEAF_TOL``
(``ADAM_LEAF_TOL``); their first gradients hold ``LEAF_TOL`` like every
other family's.  Many of their gradient elements are ~1e-5 of their leaf's
max (the heads' rare vocab columns, zero-initialised biases, the sLSTM's
gate projections), where AdamW's step, ~lr whatever |g|, turns the rounding
of the sums into ~1e-4 of a leaf, on the reference's side as on the port's.
zamba2 within ``EMBED_TOL`` (5e-4): the reference's own (2, 2) and (1, 4)
runs part by 1.5e-4 (the embedding) and 8.9e-5 (``in_proj``), the port's
one process lies 1.2e-4 from the reference's (2, 2) run (``in_proj``), its
(1, 4) mesh run 1.2e-4 from its one process (``conv_b``).  xLSTM within
1e-3: the reference's own meshes part by 2.9e-4 (the head) and 1.6e-4
(``w_gates``), the port's one process lies 4.3e-4 from the reference's
(2, 2) run and its (1, 4) mesh run 7.5e-4 from the reference's (1, 4) run
(the head).  The elements of a :func:`noise_leaves` leaf move by AdamW's
step on noise (noise / eps x lr): after the steps they are held within 2
x lr of the other side, ``test_torch_xlstm.py``'s rule.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib

import numpy as np
import pytest

import _torch_mesh_family_workers as fw
import _torch_mesh_workers as workers
from conftest import run_forced_device_subprocess
from repro_torch.distributed import sharding
from repro_torch.models import common, registry

AXES = ("data", "model")
B1 = 0.9  # AdamW's first-moment decay (the reference's and the port's default)
# a family's leaves after the AdamW steps, where above LEAF_TOL (the module's docstring)
ADAM_LEAF_TOL = {"hybrid": workers.EMBED_TOL, "ssm": 1e-3}


def noise_leaves(cfg) -> set[tuple]:
    """The leaves whose exact gradient is zero: each xLSTM block's input-gate
    bias (the mLSTM's ``b_i``; the sLSTM's gate biases, whose input gate's
    row is one: a common shift of the input gate scales C and n alike and
    cancels in h wherever |n q| or n is not clamped at 1)."""
    if cfg.family != "ssm" or cfg.hybrid_attn_every:
        return set()
    return {("blocks", i, "cell", "b_gates" if i in cfg.slstm_layers else "b_i")
            for i in range(cfg.n_layers)}


def family_runs(d: pathlib.Path, archs: list[str], *, train: bool = True,
                serve_shapes: tuple = ((2, 2),), kv_seq_shard: bool = False) -> dict:
    """The reference's runs (training on (2, 2) and (1, 4), serving on each
    of ``serve_shapes``), beside them the port's: on 4 gloo ranks, on one
    ((1, 1)) and in one process, all from ``fw.init_tree``'s weights (and
    an encoder-decoder's ``fw.train_frames``)."""
    ref_dir, port_dir = d / "ref", d / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    for arch in archs:
        workers.save_tree(ref_dir / f"{arch}.init.npz", fw.init_tree(arch))
        frames = fw.train_frames(arch)
        if frames:
            np.savez(ref_dir / f"{arch}.frames.npz", *frames)
    mesh_runs = [(a, s) for a in archs for s in fw.TRAIN_MESHES]
    suffix = "_seq" if kv_seq_shard else ""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the reference beside the ranks
        ref_train = pool.submit(run_forced_device_subprocess, fw.REFERENCE_TRAIN.format(
            runs=mesh_runs, out=str(ref_dir), steps=fw.STEPS), timeout=600) if train else None
        ref_serve = [pool.submit(run_forced_device_subprocess, fw.REFERENCE_SERVE.format(
            archs=list(archs), shape=shape, out=str(ref_dir), batch=fw.SERVE_BATCH,
            prompt=fw.SERVE_PROMPT, steps=fw.SERVE_STEPS, max_len=fw.SERVE_MAX_LEN,
            kv_seq_shard=kv_seq_shard, suffix=suffix), timeout=600) for shape in serve_shapes]
        if train:
            workers.spawn(fw.train_rank, 4, 4, mesh_runs, str(ref_dir), str(port_dir))
            workers.spawn(fw.train_rank, 1, 1, [(a, (1, 1)) for a in archs], str(ref_dir),
                          str(port_dir))
            for arch in archs:
                fw.train_one_process(arch, str(ref_dir / f"{arch}.init.npz"),
                                     fw.tag(str(port_dir), arch, ("one",)))
        for shape in tuple(serve_shapes) + ((1, 1),):
            world = shape[0] * shape[1]
            workers.spawn(fw.serve_rank, world, world, list(archs), shape, str(ref_dir),
                          str(port_dir), kv_seq_shard)
        one = {arch: fw.serve_one_process(arch, str(ref_dir / f"{arch}.init.npz"))
               for arch in archs}
        served = {}
        for f in ref_serve:
            served.update(f.result())
        trained = ref_train.result() if train else {}
    return {"ref_train": trained, "ref_serve": served, "ref_dir": str(ref_dir),
            "port_dir": str(port_dir), "one": one, "kv_seq_shard": kv_seq_shard}


# -- training -----------------------------------------------------------------------


def load_run(stem: str) -> dict:
    """A port run's metrics and placements, its first gradients and its
    leaves after the steps (the reference's trees)."""
    with open(stem + ".json") as f:
        run = json.load(f)
    run["params"] = workers.load_tree(stem + ".params.npz")
    run["grads"] = workers.load_tree(stem + ".grads.npz")
    return run


def reference_run(runs: dict, arch: str, shape: tuple) -> dict:
    """The reference's run: its metrics, specs, leaves after the steps, and
    its first gradient read off AdamW's first moment after step 1
    (``m1 / 0.1``, unclipped by the step's grad norm: one compile a run,
    not two)."""
    stem = fw.tag(runs["ref_dir"], arch, shape)
    out = dict(runs["ref_train"][stem])
    out["params"] = workers.load_tree(stem + ".params.npz")
    norm = out["metrics"][0]["grad_norm"]
    clip = min(1.0, 1.0 / max(norm, 1e-9))
    m1 = workers.load_tree(stem + ".m1.npz")
    out["grads"] = {p: x / (1 - B1) / clip for p, x in common.tree_leaves(m1)}
    with np.load(stem + ".routes.npz") as z:
        out["routes"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    return out


def assert_metrics_close(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) == fw.STEPS
    for g, w in zip(got, want):
        for k in fw.METRICS:
            if k in w:
                tol = 1e-3 if k == "grad_norm" else 1e-4
                assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1e-6), (k, g[k], w[k])


def leaf_err(got, want, floor: float = 0.0) -> float:
    """max |got - want| over the larger of the leaf's largest |want| and
    ``floor``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-30))


def assert_grads_close(got: dict, want: dict, cfg) -> None:
    """Every leaf of ``want`` (path -> array) within ``LEAF_TOL`` of its
    max; a :func:`noise_leaves` leaf against ``LEAF_TOL`` of the tree's
    largest (the module's docstring)."""
    got = {common.path_name(p): x for p, x in common.tree_leaves(got)}
    want = {common.path_name(p) if isinstance(p, tuple) else p: x for p, x in want.items()}
    assert got.keys() == want.keys()
    floor = workers.LEAF_TOL * max(float(np.abs(x).max()) for x in want.values())
    noise = {common.path_name(p) for p in noise_leaves(cfg)}
    for name, w in want.items():
        err = leaf_err(got[name], w, floor if name in noise else 0.0)
        assert err <= workers.LEAF_TOL, (name, err)


def assert_leaves_close(got: dict, want: dict, cfg) -> None:
    """Every leaf after the steps within ``LEAF_TOL`` of its max, or its
    family's ``ADAM_LEAF_TOL``, the embedding within ``EMBED_TOL`` at
    least; a :func:`noise_leaves` leaf within 2 x lr (the module's
    docstring)."""
    tol = ADAM_LEAF_TOL.get(cfg.family, workers.LEAF_TOL)
    noise = noise_leaves(cfg)
    got, want = dict(common.tree_leaves(got)), dict(common.tree_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        if path in noise:
            off = float(np.abs(np.asarray(got[path], np.float64) - w).max())
            assert off <= 2 * fw.OPT.peak_lr, (common.path_name(path), off)
            continue
        err = workers.max_err(got[path], w)
        leaf_tol = max(tol, workers.EMBED_TOL) if path == ("embed",) else tol
        assert err <= leaf_tol, (common.path_name(path), err)


def spec_placements(spec, axes=AXES) -> tuple:
    """A reference ``PartitionSpec`` (as lists) as DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axes:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, (tuple, list)) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def layer_placements(cfg, shape: tuple) -> dict[str, str]:
    """Each of the port's parameter names -> its placements (as text) at the
    reference's ``param_placements`` on a ``shape`` mesh: a stacked leaf's
    layers at the stacked placements without the layer dim."""
    lm = sharding.LogicalMesh(tuple(zip(AXES, shape)))
    want = sharding.param_placements(registry.get(cfg).spec(cfg), lm, sharding.default_rules(lm))
    stacks = registry.get(cfg).stack_sizes(cfg)
    out = {}
    for path, pl in common.tree_leaves(want):
        if path[0] in stacks:
            pl = tuple(type(p)(p.dim - 1) if hasattr(p, "dim") else p for p in pl)
            names = [common.path_name((path[0], i) + path[1:], ".")
                     for i in range(stacks[path[0]])]
        else:
            names = [common.path_name(path, ".")]
        out.update({name: str(pl) for name in names})
    return out


# -- serving ------------------------------------------------------------------------


def port_served(runs: dict, arch: str, shape: tuple) -> dict:
    stem = fw.seq_tag(runs["port_dir"], arch, shape, runs["kv_seq_shard"])
    with np.load(stem + ".serve.npz") as z:
        return dict(z)


def reference_served(runs: dict, arch: str, shape: tuple) -> dict:
    stem = fw.seq_tag(runs["ref_dir"], arch, shape, runs["kv_seq_shard"])
    with np.load(stem + ".ref_serve.npz") as z:
        out = dict(z)
    out.update(runs["ref_serve"][stem])
    return out


def assert_logits_close(got, want) -> None:
    assert got.shape == want.shape == (fw.SERVE_STEPS + 1, fw.SERVE_BATCH, want.shape[-1])
    assert np.isfinite(got).all()
    for step, (g, w) in enumerate(zip(got, want)):
        err = workers.max_err(g, w)
        assert err <= 1e-4, (step, err)


def assert_cache_at_reference(runs: dict, arch: str, shape: tuple) -> dict[str, dict]:
    """Every state leaf of every rank after prefill and decode at the
    reference's ``state_shardings`` spec (a per-layer leaf at its stack's
    spec without the layer dim), holding ``local_numel`` elements; the
    reference's jitted calls kept their state at that spec too.  Returns
    rank 0's leaves."""
    ref = reference_served(runs, arch, shape)
    assert ref["state_out"] == ref["state_specs"]
    specs = ref["state_specs"]
    lm = sharding.LogicalMesh(tuple(zip(AXES, shape)))
    stem = fw.seq_tag(runs["port_dir"], arch, shape, runs["kv_seq_shard"])
    first = None
    for rank in range(shape[0] * shape[1]):
        with open(stem + f".cache.rank{rank}.json") as f:
            cache = json.load(f)
        first = first or cache
        for name, leaf in cache.items():
            parts = name.split("/")
            if name in specs:  # the reference's own leaf (whisper's stacked caches)
                spec = tuple(specs[name])
            else:  # a per-layer leaf of a stack: the stacked spec without its layer dim
                key = "/".join(p for p in parts if not p.isdigit())
                if key in specs:
                    assert specs[key][0] is None, key  # the reference's layer dim
                    spec = tuple(specs[key][1:])
                else:  # xLSTM: a list of per-block states in both trees
                    spec = tuple(specs[name])
            assert leaf["placements"] == str(spec_placements(spec)), (rank, name)
            want = sharding.local_numel(
                tuple(leaf["shape"]), tuple(tuple(e) if isinstance(e, list) else e for e in spec),
                lm)
            assert leaf["local_numel"] == want, (rank, name)
    return first


# -- the tests a family's module collects (``from _torch_mesh_family_checks import
# test_...``); the module gives the fixtures ``arch``, ``runs`` (its
# :func:`family_runs`) and ``serve_shape`` ----------------------------------------------


@pytest.mark.parametrize("shape", fw.TRAIN_MESHES)
def test_mesh_training_matches_the_reference(runs, arch, shape):
    """Each loss, the first step's gradients leaf by leaf and every leaf
    after 3 steps: the port's mesh run against the reference's jitted step
    on its forced mesh of the same shape."""
    ref = reference_run(runs, arch, shape)
    assert ref["devices"] == 4
    got = load_run(fw.tag(runs["port_dir"], arch, shape))
    assert_metrics_close(got["metrics"], ref["metrics"])
    cfg = fw.reduced(arch)
    assert_grads_close(got["grads"], ref["grads"], cfg)
    assert_leaves_close(got["params"], ref["params"], cfg)


@pytest.mark.parametrize("shape", fw.TRAIN_MESHES)
def test_mesh_training_matches_the_one_process_run(runs, arch, shape):
    got = load_run(fw.tag(runs["port_dir"], arch, shape))
    one = load_run(fw.tag(runs["port_dir"], arch, ("one",)))
    assert_metrics_close(got["metrics"], one["metrics"])
    cfg = fw.reduced(arch)
    assert_grads_close(got["grads"], dict(common.tree_leaves(one["grads"])), cfg)
    assert_leaves_close(got["params"], one["params"], cfg)


def test_one_rank_mesh_training_is_bitwise_the_one_process_run(runs, arch):
    """On a (1, 1) gloo mesh every metric, gradient and leaf has the
    one-process run's bits."""
    got = load_run(fw.tag(runs["port_dir"], arch, (1, 1)))
    one = load_run(fw.tag(runs["port_dir"], arch, ("one",)))
    assert got["metrics"] == one["metrics"]
    for key in ("grads", "params"):
        want = dict(common.tree_leaves(one[key]))
        for path, x in common.tree_leaves(got[key]):
            np.testing.assert_array_equal(x, want[path], err_msg=common.path_name(path))


@pytest.mark.parametrize("shape", fw.TRAIN_MESHES)
def test_mesh_parameters_keep_the_reference_placements(runs, arch, shape):
    """After 3 steps every parameter lies at the reference's
    ``param_shardings`` spec (each layer's view without the stacked dim),
    and the reference's own specs, read back, say the same."""
    got = load_run(fw.tag(runs["port_dir"], arch, shape))["placements"]
    cfg = fw.reduced(arch)
    assert got == layer_placements(cfg, shape)
    lm = sharding.LogicalMesh(tuple(zip(AXES, shape)))
    want = sharding.param_placements(registry.get(cfg).spec(cfg), lm, sharding.default_rules(lm))
    specs = reference_run(runs, arch, shape)["specs"]
    for path, pl in common.tree_leaves(want):
        assert pl == spec_placements(specs[common.path_name(path)]), path


def test_mesh_serving_matches_the_reference(runs, arch, serve_shape):
    got, ref = port_served(runs, arch, serve_shape), reference_served(runs, arch, serve_shape)
    assert_logits_close(got["logits"], ref["logits"])
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    prompts = fw.serve_prompts(fw.reduced(arch))
    np.testing.assert_array_equal(got["generated"],
                                  np.concatenate([prompts, got["tokens"]], axis=1))


def test_mesh_serving_matches_the_one_process(runs, arch, serve_shape):
    got, one = port_served(runs, arch, serve_shape), runs["one"][arch]
    assert_logits_close(got["logits"], one["logits"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


def test_one_rank_mesh_serving_is_bitwise_the_one_process(runs, arch):
    got, one = port_served(runs, arch, (1, 1)), runs["one"][arch]
    np.testing.assert_array_equal(got["logits"], one["logits"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


def test_cache_leaves_keep_the_reference_placements_and_only_their_shards(runs, arch,
                                                                          serve_shape):
    assert_cache_at_reference(runs, arch, serve_shape)
