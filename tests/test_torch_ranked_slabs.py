"""The SU3 plan's t-slabs on the ranks of a process group, on the CPU.

Each configuration spawns gloo ranks (``_torch_mesh_workers.spawn``: a
``file://`` store, one CPU thread a rank) that run
``_torch_slab_workers.slab_rank``: rank ``r`` of ``world`` owns ``hosts /
world`` contiguous slabs of ``MeshSpec(hosts, devices_per_host)`` and holds
only their sites.  In the four storage forms of ``test_torch_multislab.py``
(SoA f32, AoSoA f32, bf16 + f32 accumulate, two-row) the ranks' first-touch
init, ``step``, ``fused_step(3)`` and the stencil at both ``overlap``
values and depths 1 and 2 equal the one-process slab plan bitwise (the
ranks' pieces, joined in rank order); fused and composed CG equal each
other bitwise and give the same bits twice, and lie within
``verify_tolerance`` of the one-process plan in the same iteration count
(bitwise at world 1, where the partial sum is the whole sum).

The reference runs its own multi-device plan in one subprocess over 4
forced CPU devices, on its (2, 2) and (4, 1) meshes (``REFERENCE_RUN``),
while the ranks run: the multiply on random SU(3) links, the stencil at
both ``overlap`` values and depths, and ``cg_solve`` on
``_cg_measure_problem(8)``, against the ranks of ``MeshSpec(2, 2)`` on 2
ranks and ``MeshSpec(4)`` on 4, within ``verify_tolerance`` (CG: the same 9
iterations, residuals within 1e-3).

L=8 gives slabs of 4 or 2 t-slices; at L=4 four slabs of one t-slice are
all boundary and the depth-2 ring reaches two ranks away.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_workers as mesh_workers
import _torch_slab_workers as workers
from conftest import REPO_ROOT, run_forced_device_subprocess
from repro.launch.mesh import MeshSpec as JMeshSpec
from repro_torch.core.autotune import _cg_measure_problem
from repro_torch.core.su3 import plan as tplan
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as meshes
from repro_torch.launch.mesh import MeshSpec, SlabMesh
from repro_torch.serve.su3 import ServiceConfig, SU3Service
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

# name -> (world, hosts, L, devices per host)
CONFIGS = {
    "2 ranks x 2 slabs": (2, 2, 8, 2),
    "4 ranks x 4 slabs": (4, 4, 8, 1),
    "2 ranks x 4 slabs": (2, 4, 8, 1),
    "4 ranks x 4 slabs, L=4": (4, 4, 4, 1),
    "1 rank x 2 slabs": (1, 2, 8, 2),
}
RANKED = [c for c, (world, *_) in CONFIGS.items() if world > 1]
FORMS = [f[0] for f in workers.FORMS]
LAYOUT = {f[0]: f[1] for f in workers.FORMS}
SCHEDULES = [f"{o}/{d}" for o, d in workers.SCHEDULES]
# the reference's mesh (hosts, devices per host) -> the ranks that hold it
REFERENCE_MESHES = {"2x2": "2 ranks x 2 slabs", "4x1": "4 ranks x 4 slabs"}
TOL = tplan.verify_tolerance("float32")

# The reference's plans on its (2, 2) and (4, 1) meshes over 4 forced CPU
# devices (SoA f32, L=8, tile 64), on the inputs the test saved at @INPUTS@;
# the outputs, canonical, to @OUT@.
REFERENCE_RUN = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.su3 import plan as jplan
from repro.launch.mesh import MeshSpec

data = np.load("@INPUTS@")
out, meshes = {}, []
for hosts, dph in ((2, 2), (4, 1)):
    key = f"{hosts}x{dph}"
    p = jplan.build_plan(jplan.EngineConfig(L=8, tile=64, iterations=1, warmups=0),
                         MeshSpec(hosts=hosts, devices_per_host=dph))
    meshes.append([key, dict(p.mesh.shape)])
    u, v = p.pack_gauge(jnp.asarray(data["u"])), p.pack_rhs(jnp.asarray(data["v"]))
    c = p.step(u, p.codec.pack_b(jnp.asarray(data["b"])))
    out[key + "/step"] = np.asarray(p.unpack(c))
    for overlap in (True, False):
        for depth in (1, 2):
            w = p.stencil_step(overlap=overlap, depth=depth)(u, v)
            out[f"{key}/stencil/{overlap}/{depth}"] = np.asarray(p.unpack_vec(w))
    res = p.cg_solve(p.pack_gauge(jnp.asarray(data["cg_u"])),
                     p.pack_rhs(jnp.asarray(data["cg_b"])))
    out[key + "/cg/x"] = np.asarray(p.unpack_vec(res.x_p))
    out[key + "/cg/residuals"] = np.array(res.residuals)
    out[key + "/cg/iterations"] = np.array(res.iterations)
np.savez("@OUT@", **out)
print(json.dumps({"devices": len(jax.devices()), "meshes": meshes}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every configuration's ranks, the one-process plans, and (in a thread,
    alongside) the reference's subprocess."""
    d = tmp_path_factory.mktemp("ranked_slabs")
    u, v, b = workers.field(8)
    cg_u, cg_b = _cg_measure_problem(8)
    np.savez(d / "inputs.npz", u=u, v=v, b=b, cg_u=cg_u, cg_b=cg_b)
    code = REFERENCE_RUN.replace("@INPUTS@", str(d / "inputs.npz")).replace(
        "@OUT@", str(d / "reference.npz"))
    ref: dict = {}

    def reference() -> None:
        try:
            ref["json"] = run_forced_device_subprocess(code, timeout=600)
        except BaseException as e:  # re-raised in the test's thread
            ref["error"] = e

    thread = threading.Thread(target=reference)
    thread.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = {}
        for name, (world, hosts, L, dph) in CONFIGS.items():
            out = d / f"w{world}h{hosts}L{L}"
            out.mkdir()
            mesh_workers.spawn(workers.slab_rank, world, world, hosts, L, str(out), dph)
            ranks[name] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
        one = {key: workers.one_process(*key)
               for key in sorted({(h, L, dph) for _, h, L, dph in CONFIGS.values()})}
    finally:
        torch.set_num_threads(threads)
        thread.join()
    if "error" in ref:
        raise ref["error"]
    ref.update(dict(np.load(d / "reference.npz")))
    return {"ranks": ranks, "one": one, "reference": ref}


def _one(runs, config: str) -> dict:
    _, hosts, L, dph = CONFIGS[config]
    return runs["one"][(hosts, L, dph)]


def _joined(ranks: list[dict], key: str, layout: str) -> np.ndarray:
    """The ranks' pieces of a site-indexed tensor, in rank order (SoA and
    planar vectors along the last axis, AoSoA tiles along the first)."""
    physical = key.rsplit("/", 1)[-1] in ("a", "step", "fused3")
    axis = 0 if physical and layout == "aosoa" else -1
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _sites(shape, layout: str) -> int:
    return int(shape[0] * workers.TILE if layout == "aosoa" else shape[-1])


# -- init, the multiply, the stencil: bitwise against the one-process plan -------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("config", CONFIGS)
def test_first_touch_holds_only_the_ranks_slabs(runs, config, form):
    world, hosts, L, _ = CONFIGS[config]
    ranks = runs["ranks"][config]
    for r, res in enumerate(ranks):
        lo, hi = sharding.rank_site_range(L**4, hosts, world, r)
        assert tuple(res[f"{form}/site_range"]) == (lo, hi)
        # no rank holds more than its share of the lattice
        assert _sites(res[f"{form}/a_shape"], LAYOUT[form]) == hi - lo == L**4 // world
        assert str(res[f"{form}/describe"]).endswith(f"/rank{r}of{world}")
    np.testing.assert_array_equal(_joined(ranks, f"{form}/a", LAYOUT[form]),
                                  _one(runs, config)[f"{form}/a"])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("config", CONFIGS)
def test_step_and_fused_step_equal_one_process(runs, config, form):
    ranks, one = runs["ranks"][config], _one(runs, config)
    for key in ("step", "fused3"):
        np.testing.assert_array_equal(_joined(ranks, f"{form}/{key}", LAYOUT[form]),
                                      one[f"{form}/{key}"])
    assert all(bool(r[f"{form}/verify"]) for r in ranks)
    assert all(bool(r[f"{form}/verify_stencil"]) for r in ranks)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("config", CONFIGS)
def test_stencil_equals_one_process(runs, config, form, schedule):
    ranks, one = runs["ranks"][config], _one(runs, config)
    key = f"{form}/stencil/{schedule}"
    np.testing.assert_array_equal(_joined(ranks, key, LAYOUT[form]), one[key])
    depth = schedule.split("/")[1]
    for r in ranks:  # overlap and not: the same bits on every rank
        np.testing.assert_array_equal(r[f"{form}/stencil/True/{depth}"],
                                      r[f"{form}/stencil/False/{depth}"])
        # unpack_vec gathers every rank's sites: the same field on each
        np.testing.assert_array_equal(r[f"{form}/stencil_whole/{schedule}"],
                                      ranks[0][f"{form}/stencil_whole/{schedule}"])


# -- CG --------------------------------------------------------------------------------


@pytest.mark.parametrize("form", workers.CG_FORMS)
@pytest.mark.parametrize("config", CONFIGS)
def test_cg_fused_equals_composed_and_repeats_bitwise(runs, config, form):
    for r in runs["ranks"][config]:
        fused = {k: r[f"{form}/cg/fused/{k}"] for k in ("x", "residuals", "iterations")}
        for other in ("composed", "fused_again"):
            for k, want in fused.items():
                np.testing.assert_array_equal(r[f"{form}/cg/{other}/{k}"], want)
        assert bool(r[f"{form}/cg/fused/converged"])


@pytest.mark.parametrize("form", workers.CG_FORMS)
@pytest.mark.parametrize("config", CONFIGS)
def test_cg_on_ranks_against_one_process(runs, config, form):
    world = CONFIGS[config][0]
    ranks, one = runs["ranks"][config], _one(runs, config)
    res = ranks[0]
    assert int(res[f"{form}/cg/fused/iterations"]) == int(one[f"{form}/cg/iterations"]) == 9
    if world == 1:  # the partial sum is the whole sum: the one process's bits
        np.testing.assert_array_equal(res[f"{form}/cg/fused/x"], one[f"{form}/cg/x"])
        np.testing.assert_array_equal(res[f"{form}/cg/fused/residuals"],
                                      one[f"{form}/cg/residuals"])
        return
    for r in ranks:  # every rank reduced to the same scalars
        np.testing.assert_array_equal(r[f"{form}/cg/fused/residuals"],
                                      res[f"{form}/cg/fused/residuals"])
    assert np.max(np.abs(res[f"{form}/cg/fused/x_whole"] - one[f"{form}/cg/x_whole"])) <= TOL
    np.testing.assert_allclose(res[f"{form}/cg/fused/residuals"], one[f"{form}/cg/residuals"],
                               rtol=1e-3)


# -- against the reference's multi-device plan --------------------------------------------


def test_the_reference_ran_on_its_meshes(runs):
    ref = runs["reference"]["json"]
    assert ref["devices"] == 4
    assert ref["meshes"] == [["2x2", {"hosts": 2, "devices": 2}],
                             ["4x1", {"hosts": 4, "devices": 1}]]


@pytest.mark.parametrize("what", ["step", *[f"stencil/{s}" for s in SCHEDULES], "cg"])
@pytest.mark.parametrize("mesh", REFERENCE_MESHES)
def test_ranks_against_the_reference_mesh(runs, mesh, what):
    ref = runs["reference"]
    for r in runs["ranks"][REFERENCE_MESHES[mesh]]:
        if what == "step":
            got, want = r["soa f32/random_step"], ref[f"{mesh}/step"]
        elif what == "cg":
            assert int(r["soa f32/cg/fused/iterations"]) == int(ref[f"{mesh}/cg/iterations"]) == 9
            np.testing.assert_allclose(r["soa f32/cg/fused/residuals"],
                                       ref[f"{mesh}/cg/residuals"], rtol=1e-3)
            got, want = r["soa f32/cg/fused/x_whole"], ref[f"{mesh}/cg/x"]
        else:
            got, want = r[f"soa f32/stencil_whole/{what[8:]}"], ref[f"{mesh}/{what}"]
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= TOL * max(1.0, float(np.max(np.abs(want))))


# -- placements, the engine, provenance, spans, faults, refusals -----------------------------


@pytest.mark.parametrize("config", CONFIGS)
def test_host_scatter_and_replicated_placements(runs, config):
    world, _, L, _ = CONFIGS[config]
    for r in runs["ranks"][config]:
        # rank 0 builds on its host and scatters: each rank gets first touch's bits
        np.testing.assert_array_equal(r["host_scatter/a"], r["soa f32/a"])
        assert _sites(r["replicated/a_shape"], "soa") == L**4  # every rank the whole lattice
        assert bool(r["host_scatter/verify"]) and bool(r["replicated/verify"])


@pytest.mark.parametrize("config", CONFIGS)
def test_engine_row_provenance_and_spans_on_ranks(runs, config):
    world = CONFIGS[config][0]
    for rank, r in enumerate(runs["ranks"][config]):
        row = json.loads(str(r["engine_row"]))
        assert row["verified"] and row["world"] == world and len(row["rank_init_s"]) == world
        assert row["GBYTES"] > 0 and row["plan"].endswith(f"/rank{rank}of{world}")
        assert r["provenance"].tolist() == [str(world), "gloo"]
        assert [tuple(x) for x in r["span_ranks"]] == [
            (name, str(rank)) for name in ("stencil.exchange", "stencil.interior",
                                           "stencil.boundary")]
        np.testing.assert_array_equal(r["traced"], r["clean"])


@pytest.mark.parametrize("config", RANKED)
def test_halo_fault_on_one_rank_corrupts_only_its_received_ghosts(runs, config):
    for rank, r in enumerate(runs["ranks"][config]):
        np.testing.assert_array_equal(r["after"], r["clean"])  # the next step is clean
        if rank:
            assert int(r["fired"]) == 0
            np.testing.assert_array_equal(r["faulted"], r["clean"])
            continue
        assert int(r["fired"]) == 1
        changed = np.nonzero((r["faulted"] != r["clean"]).any(axis=(0, 1)))[0]
        assert changed.size and set(changed) <= set(r["boundary"].tolist())


@pytest.mark.parametrize("config", CONFIGS)
def test_faces_go_to_the_t_neighbour_ranks_only(runs, config):
    world = CONFIGS[config][0]
    for rank, r in enumerate(runs["ranks"][config]):
        want = sorted(set(sharding.t_peers(rank, world)) - {rank})  # no rank sends to itself
        assert r["face_peers"].tolist() == want


@pytest.mark.parametrize("config", RANKED)
def test_ranked_meshes_refuse_bad_requests(runs, config):
    world, hosts = CONFIGS[config][:2]
    for r in runs["ranks"][config]:
        uneven, on_card = (str(x) for x in r["refusals"])
        assert f"hosts={world + 1}" in uneven and f"{world} ranks" in uneven
        assert "nccl" in on_card and "gloo" in on_card


# -- in this process: the rank arithmetic, the per-host devices, the service -----------------


def test_rank_arithmetic():
    assert [list(sharding.rank_slabs(r, 4, 2)) for r in range(2)] == [[0, 1], [2, 3]]
    assert [sharding.slab_owner(h, 4, 2) for h in range(4)] == [0, 0, 1, 1]
    assert sharding.rank_site_range(4096, 4, 2, 1) == (2048, 4096)
    assert sharding.t_peers(0, 2) == (1, 1)  # at world 2 both neighbours are one peer
    assert sharding.t_peers(0, 4) == (3, 1) and sharding.t_peers(0, 1) == (0, 0)
    with pytest.raises(ValueError, match="hosts=3 .* 2 ranks"):
        sharding.rank_slabs(0, 3, 2)
    with pytest.raises(ValueError, match="hosts=6 is not a multiple of the world's 4 ranks"):
        SlabMesh(6, 1, torch.device("cpu"), 0, 4)


def test_without_a_group_resolve_keeps_the_one_process_mesh():
    mesh = MeshSpec(hosts=2).resolve("cpu")
    assert mesh == SlabMesh(2, 1, torch.device("cpu"))
    assert not mesh.is_ranked and mesh.group is None and list(mesh.slabs) == [0, 1]
    plan = tplan.build_plan(workers.config(8, "soa f32"), mesh)
    assert plan.site_range == (0, 4096) and plan.local_sites == plan.padded_sites
    assert not plan.describe().endswith("of1")


def test_nccl_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                                world_size=1)


@pytest.mark.parametrize("hosts,dph,pool", [(2, 0, 4), (2, 0, 1), (4, 1, 2), (2, 2, 4),
                                            (3, 0, 7), (4, 0, 8)])
def test_host_devices_match_the_reference(hosts, dph, pool):
    devices = list(range(pool))
    port, ref = MeshSpec(hosts, dph), JMeshSpec(hosts, dph)
    for h in range(hosts):
        assert port.host_devices(h, devices) == ref.host_devices(h, devices)
        cpus = [torch.device("cpu")] * pool
        sub, jsub = port.host_submesh(h, cpus), ref.host_submesh(h, [jax.devices()[0]] * pool)
        assert sub.shape == dict(jsub.shape) and sub.device == torch.device("cpu")
    with pytest.raises(ValueError, match="out of range"):
        port.host_devices(hosts, devices)


def test_service_places_host_runners_on_host_devices(monkeypatch):
    cfg = ServiceConfig(hosts=2, autotune=False, tile=16)
    svc = SU3Service(cfg, device="cpu")
    assert svc.host_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((4, [0, 2]), (2, [0, 1]), (1, [0, 0])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=cards: n)
        placed = SU3Service(cfg, device="cuda").host_devices
        assert placed == [torch.device("cuda", i) for i in want]
    assert SU3Service(cfg, device="cuda:1").host_devices == [torch.device("cuda", 1)] * 2


def test_service_with_two_hosts_on_the_cpu_is_unchanged():
    """hosts=2 on the CPU: both hosts' runners on the CPU, every result the
    bits of a one-host service's."""
    results = []
    for hosts in (1, 2):
        svc = SU3Service(ServiceConfig(hosts=hosts, autotune=False, tile=16), device="cpu")
        ids = [svc.submit(torch.from_numpy(workers.su3(L**4, 20 + L)),
                          torch.from_numpy(workers.su3(1, 30 + L)[0]), k=2) for L in (2, 3)]
        svc.run_until_drained()
        results.append([svc.pop_result(i) for i in ids])
        assert {key[0] for key in svc.pool_keys()} == set(range(hosts))
        assert all(r.device == torch.device("cpu") for r in svc._pool.values())
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_the_example_runs_under_torch_distributed_run():
    """``examples/torch/ranked_slabs.py`` on two gloo ranks owning 4 slabs:
    the engine, the stencil and CG (9 iterations) pass on every rank."""
    env = dict(os.environ)
    src = str(REPO_ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else src
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "examples/torch/ranked_slabs.py", "--device", "cpu", "--hosts", "4", "--L", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["engine"]["verified"] and row["engine"]["world"] == 2 and row["stencil_ok"]
    assert (row["cg_iterations"], row["slabs_per_rank"], row["site_range"]) == (9, 2, [0, 2048])
