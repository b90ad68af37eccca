"""The elastic restart on the port's meshes (counterpart of the reference's
``tests/test_elastic_restart.py``): train on a (2, 2) mesh of 4 gloo ranks,
checkpoint, lose two hosts, re-plan the mesh with ``ElasticMeshPlanner``,
restore onto the planner's (1, 2) mesh of 2 ranks and train on.

The 10 losses (6 before the restart, 4 after) are held against the
reference's 10 uninterrupted steps on its 2 x 2 mesh at ``rtol=1e-4``
(the reference's own test asks ``|delta| < 1.0`` of the first loss after
the restart); every leaf after step 10 against the port's uninterrupted
one-process run, within 1e-4 of the leaf's max (the tied embedding within
5e-4: ``test_torch_mesh_train.py``'s docstring says why).  The CLI does the
same under ``torch.distributed.run``: ``--mesh 1,2``, then ``--restart-from
... --alive h0 --dead h1`` on the planner's one rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_workers as workers
from conftest import REPO_ROOT, run_forced_device_subprocess
from repro_torch.distributed.fault_tolerance import ElasticMeshPlanner
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

BEFORE, AFTER = 6, 4


def _plan():
    return ElasticMeshPlanner(devices_per_host=1, model_axis=2, global_batch=4).plan(
        alive_hosts=["h0", "h1"], dead_hosts=["h2", "h3"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    ref_out = str(d / "ref")
    ref = run_forced_device_subprocess(
        workers.REFERENCE_RUN.format(steps=BEFORE + AFTER, keep=BEFORE + AFTER, out=ref_out),
        timeout=600)
    init_path = ref_out + ".init.npz"
    ckpt = str(d / "ckpt")
    workers.spawn(workers.train_rank, 4, 4, (2, 2), init_path, BEFORE, str(d / "phase1.npz"),
                  ckpt)
    plan = _plan()
    workers.spawn(workers.train_rank, plan.n_devices, plan.n_devices, (plan.data, plan.model),
                  init_path, AFTER, str(d / "phase2.npz"), None, ckpt)
    phases = []
    for name in ("phase1", "phase2"):
        with np.load(d / f"{name}.npz") as z:
            phases.append({k: z[k] for k in z.files})
    phases[1]["params"] = workers.load_tree(d / "phase2.npz.params.npz")
    one = workers.train_one_process(workers.load_tree(init_path), BEFORE + AFTER)
    return {"reference": ref, "phases": phases, "one": one, "ckpt": ckpt}


def test_the_planner_keeps_the_model_axis():
    plan = _plan()
    assert (plan.data, plan.model, plan.n_devices) == (1, 2, 2)
    assert plan.dropped_hosts == ("h2", "h3")


def test_ten_losses_across_the_restart_match_the_reference(runs):
    p1, p2 = runs["phases"]
    assert int(p1["pipeline_step"]) == BEFORE and int(p1["count"]) == BEFORE
    assert int(p2["pipeline_step"]) == BEFORE + AFTER and int(p2["count"]) == BEFORE + AFTER
    losses = np.concatenate([p1["losses"], p2["losses"]])
    np.testing.assert_allclose(losses, runs["reference"]["losses"], rtol=1e-4)
    np.testing.assert_allclose(losses, runs["one"]["losses"], rtol=1e-4)
    assert abs(p2["losses"][0] - p1["losses"][-1]) < 1.0  # the reference's own bar


def test_leaves_after_the_restart_match_an_uninterrupted_run(runs):
    workers.assert_leaves_close(runs["phases"][1]["params"], runs["one"]["params"])


def test_the_checkpoint_is_written_once_and_whole(runs):
    steps = sorted(os.listdir(runs["ckpt"]))
    assert steps == [f"step_{BEFORE:08d}"]
    assert sorted(os.listdir(os.path.join(runs["ckpt"], steps[0]))) == ["arrays.npz",
                                                                         "manifest.json"]


def _torchrun(nproc: int, *args: str) -> str:
    env = dict(os.environ)
    src = str(REPO_ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else src
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", "repro_torch.launch.train", "--arch", "qwen3-4b", "--device", "cpu",
         "--global-batch", "4", "--seq-len", "16", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_trains_on_a_mesh_and_restarts_on_the_survivors(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _torchrun(2, "--mesh", "1,2", "--steps", "2", "--checkpoint-dir", ckpt)
    assert "done on mesh {'data': 1, 'model': 2}" in first
    second = _torchrun(1, "--mesh", "1,2", "--steps", "3", "--restart-from", ckpt,
                       "--alive", "h0", "--dead", "h1")
    assert "MeshPlan(data=1, model=1" in second
    assert "restored checkpoint at step 2" in second
    assert "done on mesh {'data': 1, 'model': 1}" in second
