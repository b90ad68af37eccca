"""The MoE and MLA families (granite-moe-1b-a400m and deepseek-v3-671b,
reduced: 8 experts, 4 heads, deepseek's MTP head kept) trained on the
port's (data, model) meshes over 4 gloo ranks, against the reference's
jitted ``make_train_step(..., param_shardings=p_sh)`` on its forced
4-device CPU meshes (``in_shardings=(p_sh, opt_sh, b_sh)``, as its
``lower_cell`` builds the step), against the port's one process, and on a
(1, 1) mesh bitwise against that one process.  Also the placements of
every arch's decode state against the reference's ``state_shardings``.

Tolerances are ``test_torch_mesh_train.py``'s: each loss (and its nll,
aux and mtp_nll) within 1e-4 relative, the grad norm 1e-3, the first
step's gradients leaf by leaf within 1e-4 of each leaf's max, every leaf
after 3 steps within ``LEAF_TOL`` (the tied embedding ``EMBED_TOL``).  The
reference's first gradient is read off AdamW's first moment after step 1
(``m1 / 0.1``, unclipped by the step's grad norm: one compile a run, not
two).  The routing (each token's expert ids in every MoE layer) must be
equal.  On the (1, 4) mesh granite-moe's 2 kv heads do not divide the
model axis and stay whole on every rank (the reference's fallback);
deepseek-v3's (1, 4) run is held against the port's one process (the
reference compiles a deepseek step for ~40 s a mesh).
"""
import concurrent.futures

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh_family_checks as checks
import _torch_mesh_family_workers as fw
import _torch_mesh_workers as workers
from conftest import run_forced_device_subprocess
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.models import registry as jregistry
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import sharding
from repro_torch.models import common, registry
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

GRANITE, DEEPSEEK = fw.TRAIN_ARCHS
REFERENCE_RUNS = [(GRANITE, (2, 2)), (DEEPSEEK, (2, 2)), (GRANITE, (1, 4))]
MESH_RUNS = [(a, s) for a in fw.TRAIN_ARCHS for s in fw.TRAIN_MESHES]


def _routes(stem: str, ranks: list[int]) -> list[np.ndarray]:
    """Each MoE layer's expert ids over the whole batch: the given ranks'
    groups in order."""
    parts = []
    for r in ranks:
        with np.load(f"{stem}.routes.rank{r}.npz") as z:
            parts.append([z[f"arr_{i}"] for i in range(len(z.files))])
    return [np.concatenate(layer, axis=0) for layer in zip(*parts)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, the port's on 4 gloo ranks ((2, 2) and (1, 4)
    for both archs, one process group), on one gloo rank ((1, 1)) and in
    one process, all from the same weights (``fw.init_tree``)."""
    d = tmp_path_factory.mktemp("mesh_families")
    ref_dir, port_dir = d / "ref", d / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    for arch in fw.TRAIN_ARCHS:
        workers.save_tree(ref_dir / f"{arch}.init.npz", fw.init_tree(arch))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the reference beside the ranks
        ref = pool.submit(run_forced_device_subprocess, fw.REFERENCE_TRAIN.format(
            runs=REFERENCE_RUNS, out=str(ref_dir), steps=fw.STEPS), timeout=600)
        workers.spawn(fw.train_rank, 4, 4, MESH_RUNS, str(ref_dir), str(port_dir))
        workers.spawn(fw.train_rank, 1, 1, [(a, (1, 1)) for a in fw.TRAIN_ARCHS], str(ref_dir),
                      str(port_dir))
        for arch in fw.TRAIN_ARCHS:
            fw.train_one_process(arch, str(ref_dir / f"{arch}.init.npz"),
                                 fw.tag(str(port_dir), arch, ("one",)))
        ref = ref.result()
    return {"ref_train": ref, "ref_dir": str(ref_dir), "port_dir": str(port_dir)}


@pytest.mark.parametrize("arch,shape", REFERENCE_RUNS)
def test_mesh_training_matches_the_reference(runs, arch, shape):
    """Each loss, the first step's gradients leaf by leaf, every leaf after
    3 steps, and the routing: the port's mesh run against the reference's
    jitted step on its forced mesh of the same shape."""
    ref = checks.reference_run(runs, arch, shape)
    assert ref["devices"] == 4
    stem = fw.tag(runs["port_dir"], arch, shape)
    got = checks.load_run(stem)
    checks.assert_metrics_close(got["metrics"], ref["metrics"])
    grads = {common.path_name(p): x for p, x in common.tree_leaves(got["grads"])}
    for path, w in ref["grads"].items():
        err = workers.max_err(grads[common.path_name(path)], w)
        assert err <= workers.LEAF_TOL, (common.path_name(path), err)
    workers.assert_leaves_close(got["params"], ref["params"])
    data = shape[0]
    ranks = [r * shape[1] for r in range(data)]  # model coordinate 0 of each data row
    routes = _routes(stem, ranks)
    assert len(routes) == len(ref["routes"]) > 0
    for layer, (g, w) in enumerate(zip(routes, ref["routes"])):
        np.testing.assert_array_equal(g, w, err_msg=f"MoE layer {layer}")


@pytest.mark.parametrize("arch,shape", MESH_RUNS)
def test_mesh_training_matches_the_one_process_run(runs, arch, shape):
    """Every mesh run against the port's one process, within the same
    bounds; every model rank of a data row routes its groups alike."""
    got = checks.load_run(fw.tag(runs["port_dir"], arch, shape))
    one = checks.load_run(fw.tag(runs["port_dir"], arch, ("one",)))
    checks.assert_metrics_close(got["metrics"], one["metrics"])
    workers.assert_leaves_close(got["grads"], one["grads"], embed_tol=workers.LEAF_TOL)
    workers.assert_leaves_close(got["params"], one["params"])
    stem = fw.tag(runs["port_dir"], arch, shape)
    for row in range(shape[0]):
        first = _routes(stem, [row * shape[1]])
        for col in range(1, shape[1]):
            for a, b in zip(first, _routes(stem, [row * shape[1] + col])):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", fw.TRAIN_ARCHS)
def test_one_rank_mesh_is_bitwise_the_one_process_run(runs, arch):
    """On a (1, 1) gloo mesh every metric, gradient, leaf and route has the
    one-process run's bits."""
    got = checks.load_run(fw.tag(runs["port_dir"], arch, (1, 1)))
    one = checks.load_run(fw.tag(runs["port_dir"], arch, ("one",)))
    assert got["metrics"] == one["metrics"]
    for key in ("grads", "params"):
        want = dict(common.tree_leaves(one[key]))
        for path, x in common.tree_leaves(got[key]):
            np.testing.assert_array_equal(x, want[path], err_msg=common.path_name(path))
    for a, b in zip(_routes(fw.tag(runs["port_dir"], arch, (1, 1)), [0]),
                    _routes(fw.tag(runs["port_dir"], arch, ("one",)), [0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,shape", MESH_RUNS)
def test_mesh_parameters_keep_the_reference_placements(runs, arch, shape):
    """After 3 steps every parameter lies at the reference's
    ``param_shardings`` spec (each layer's view without the stacked dim):
    the experts over the model axis, MLA's latents whole over it."""
    got = checks.load_run(fw.tag(runs["port_dir"], arch, shape))["placements"]
    cfg = get_config(arch).reduced()
    lm = sharding.LogicalMesh.of(data=shape[0], model=shape[1])
    want = sharding.param_placements(registry.get(cfg).spec(cfg), lm, sharding.default_rules(lm))
    stacks = registry.get(cfg).stack_sizes(cfg)
    for path, pl in common.tree_leaves(want):
        if path[0] in stacks:
            pl = tuple(type(p)(p.dim - 1) if hasattr(p, "dim") else p for p in pl)
            names = [common.path_name((path[0], i) + path[1:], ".")
                     for i in range(stacks[path[0]])]
        else:
            names = [common.path_name(path, ".")]
        for name in names:
            assert got[name] == str(pl), name
    if (arch, shape) in REFERENCE_RUNS:  # and the reference's own specs, read back
        specs = runs["ref_train"][fw.tag(runs["ref_dir"], arch, shape)]["specs"]
        for path, pl in common.tree_leaves(want):
            assert pl == checks.spec_placements(specs[common.path_name(path)]), path
    if arch == DEEPSEEK:
        assert got["layers.0.attn.w_dc"].endswith("Replicate())")  # the latent: not over model


def test_moe_and_mla_activation_kinds_resolve_as_the_reference():
    """The kinds at the MoE and MLA sites (``"gecd"``, ``"btd"``,
    ``"bthd"``) are the reference's, and resolve as its ``shard`` does:
    groups over data and experts over model where they divide, else whole;
    MLA's one k_rope channel whole over model."""
    from repro.distributed import act_sharding as jact_sharding
    from repro_torch.distributed import act_sharding

    for kind in ("gecd", "btd", "bthd"):
        assert act_sharding.KINDS[kind] == jact_sharding.KINDS[kind]
    lm = sharding.LogicalMesh.of(data=2, model=4)
    rules = sharding.default_rules(lm)
    assert act_sharding.spec_for("gecd", (4, 8, 5, 16), lm, rules) == ("data", "model")
    assert act_sharding.spec_for("gecd", (4, 6, 5, 16), lm, rules) == ("data",)
    assert act_sharding.spec_for("gecd", (3, 8, 5, 16), lm, rules) == (None, "model")
    assert act_sharding.spec_for("bthd", (4, 32, 1, 16), lm, rules) == ("data",)
    assert act_sharding.spec_for("bthd", (4, 32, 8, 48), lm, rules) == ("data", None, "model")


# -- the decode state's placements, every arch, without ranks ----------------------

STATE_MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
                "pod 2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("kv_seq_shard", [False, True])
@pytest.mark.parametrize("mesh_label", list(STATE_MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_state_placements_equal_the_reference(arch, mesh_label, kv_seq_shard):
    """``state_placements`` against the reference's ``state_shardings`` for
    the arch's decode state, on an abstract mesh (no devices, no ranks):
    the reference's stacked leaves exactly, and the port's own state (a
    list of per-layer caches where the reference stacks them) as the
    stacked leaf's placements without the layer dim."""
    import jax.numpy as jnp
    import jax

    shape, axes = STATE_MESHES[mesh_label]
    jmesh = AbstractMesh(shape, axes)
    lm = sharding.LogicalMesh(tuple(zip(axes, shape)))
    rules = sharding.default_rules(lm)
    jcfg, cfg = jget_config(arch), get_config(arch)
    sds = jregistry.get(jcfg).state_spec(jcfg, 8, 64, jnp.bfloat16)
    want = jsharding.state_shardings(sds, jmesh, jsharding.default_rules(jmesh),
                                     kv_seq_shard=kv_seq_shard)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    want_pl = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
               checks.spec_placements(s.spec, axes) for p, s in flat}
    # the reference's own leaves (shapes on meta), exactly
    stacked = {}
    for p, s in jax.tree_util.tree_flatten_with_path(sds)[0]:
        common.tree_set(stacked, tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
                        torch.empty(s.shape, device="meta"))
    got = dict(common.tree_leaves(sharding.state_placements(stacked, lm, rules,
                                                            kv_seq_shard=kv_seq_shard)))
    assert got == want_pl
    # the port's state
    state = registry.get(cfg).init_state(cfg, 8, 64, torch.bfloat16, device="meta")
    ported = dict(common.tree_leaves(sharding.state_placements(state, lm, rules,
                                                               kv_seq_shard=kv_seq_shard)))
    for path, pl in ported.items():
        if path in want_pl:
            assert pl == want_pl[path], path
            continue
        ref_path = tuple(k for k in path if not isinstance(k, int))
        want_stacked = want_pl[ref_path]
        assert all(getattr(p, "dim", 1) > 0 for p in want_stacked), path
        assert pl == tuple(type(p)(p.dim - 1) if hasattr(p, "dim") else p
                           for p in want_stacked), path
