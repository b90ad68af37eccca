"""(data, model)-sharded training of the dense family on a (2, 2) mesh of 4
gloo ranks, against the reference's jitted train step on its (2, 2) mesh
over 4 forced CPU devices, and against the port's one-process step.

``qwen3-4b.reduced()`` (4 layers, d 128, 4/2 heads of 32, vocab 512) in
f32, the reference's weights from ``PRNGKey(0)`` carried by
``params_from_reference`` and placed by ``distribute_tree``; the setting of
the reference's ``tests/test_elastic_restart.py`` (``_torch_mesh_workers``).
Three steps; tolerances are ``test_torch_train.py``'s: the loss within
1e-4 relative, the grad norm 1e-3, every leaf of the first step's
gradients and every leaf after the steps within 1e-4 of its largest
magnitude (sums run in another order over the mesh: partial sums over the
model axis, the norm's all-reduce).  The gradients are held leaf by leaf
because AdamW's update hides a gradient off by a constant factor (it
divides by sqrt(v)).  The one exception is the tied embedding after the
AdamW steps, held within ``EMBED_TOL`` of its max
(``_torch_mesh_workers.assert_leaves_close``; its gradient is held within
1e-4 like every other leaf).  A few of its 65,536 elements get gradients
of alternating sign whose first moment nearly cancels while the second
stays ~3e-10, so AdamW's step there carries the rounding of the sums at
~1e-2 of a step: the port's one-process run lies 2.1e-4 (3 steps) and
2.6e-4 (10 steps) of the leaf's max from the reference's, the mesh run
1.0e-4 / 1.3e-4 from the one-process run and 1.05e-4 / 1.3e-4 from the
reference; every other leaf within 1e-5.
"""
import numpy as np
import pytest

import _torch_mesh_workers as workers
from conftest import run_forced_device_subprocess
from repro_torch.distributed import sharding
from repro_torch.models import common, registry
from repro_torch.configs import get_config
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 3 steps on its 2 x 2 mesh, the port's on 4 gloo
    ranks (2, 2) from the same weights, and the port's one process."""
    d = tmp_path_factory.mktemp("mesh_train")
    ref_out = str(d / "ref")
    ref = run_forced_device_subprocess(
        workers.REFERENCE_RUN.format(steps=STEPS, keep=STEPS, out=ref_out), timeout=600)
    ref["params"] = workers.load_tree(ref_out + ".params.npz")
    ref["grads"] = workers.load_tree(ref_out + ".grads.npz")
    init_path = ref_out + ".init.npz"
    mesh_out = str(d / "mesh.npz")
    workers.spawn(workers.train_rank, 4, 4, (2, 2), init_path, STEPS, mesh_out)
    with np.load(mesh_out) as z:
        mesh = {k: z[k] for k in z.files}
    mesh["params"] = workers.load_tree(mesh_out + ".params.npz")
    mesh["grads"] = workers.load_tree(mesh_out + ".grads.npz")
    one = workers.train_one_process(workers.load_tree(init_path), STEPS)
    return {"reference": ref, "mesh": mesh, "one": one}


def _assert_close(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-3)
    workers.assert_leaves_close(got["params"], want["params"])


def test_the_reference_ran_on_its_mesh(runs):
    ref = runs["reference"]
    assert ref["devices"] == 4 and ref["embed_spec"] == "PartitionSpec('model', 'data')"
    assert len(ref["losses"]) == STEPS


def test_mesh_steps_match_the_reference_2x2(runs):
    _assert_close(runs["mesh"], runs["reference"])


def test_mesh_steps_match_the_one_process_steps(runs):
    _assert_close(runs["mesh"], runs["one"])


@pytest.mark.parametrize("want", ["reference", "one"])
def test_mesh_grads_match_leaf_by_leaf(runs, want):
    """The first step's gradient of every leaf, the embedding included,
    within 1e-4 of that leaf's max: against the reference's on its 2 x 2
    mesh and the port's one process."""
    workers.assert_leaves_close(runs["mesh"]["grads"], runs[want]["grads"],
                                embed_tol=workers.LEAF_TOL)


def test_mesh_state_keeps_the_reference_placements(runs):
    """After three steps every parameter still lies at its
    ``param_placements`` (gradients and updates kept them), the step count
    is 3 and the pipeline moved 3 batches."""
    mesh = runs["mesh"]
    assert int(mesh["count"]) == STEPS and int(mesh["pipeline_step"]) == STEPS
    cfg = get_config(workers.ARCH).reduced()
    lm = sharding.LogicalMesh.of(data=2, model=2)
    want = sharding.param_placements(registry.get(cfg).spec(cfg), lm, sharding.default_rules(lm))
    got = dict(mesh["placements"].tolist())
    stacks = registry.get(cfg).stack_sizes(cfg)
    for path, pl in common.tree_leaves(want):
        if path[0] in stacks:  # each layer's view: the stacked dim is gone
            pl = tuple(type(p)(p.dim - 1) if hasattr(p, "dim") else p for p in pl)
            names = [common.path_name((path[0], i) + path[1:], ".") for i in range(stacks[path[0]])]
        else:
            names = [common.path_name(path, ".")]
        for name in names:
            assert got[name] == str(pl), name
