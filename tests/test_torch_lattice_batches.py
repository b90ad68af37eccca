"""Whole-lattice request batches and megakernel slot tables spread over a
mesh's devices and over the ranks of a process group, on the CPU.

The reference shards a batch of whole lattices (``BatchedLatticeRunner``,
``fused_batched_step``) over its mesh with ``lattice_batch_sharding``:
whole lattices per device, host-major.  It runs once per module, in one
subprocess over 4 forced CPU devices (``REFERENCE_RUN``), on its (2, 2) and
(4, 1) meshes: the runner on a batch of 5 lattices at L=4 (SoA f32, k=1 and
3) and the megakernel over a 4-slot table with depths [0, 1, 3, 4] and over
a 3-slot table, with each output's ``devices_indices_map``.

The port's block map (``ExecutionPlan.lattice_batch_blocks``,
``slot_table_blocks``) must equal those maps, and its results must lie
within ``verify_tolerance`` of the reference's and equal the port's
one-device runner bit for bit:

  * in one process over a device list of 4: the CPU four times (one tensor
    holds every block) and ``cpu:0 .. cpu:3`` (four distinct devices: a
    list of tensors, one per device);
  * over 2 and 4 gloo ranks (``_torch_batch_workers.batch_rank``, each rank
    holding only its blocks).

``SU3Service`` over a 2-host x 2-device list of CPU devices, in batch,
continuous, megakernel and stencil modes and under an armed fault plan,
gives the one-device service's bits.
"""
import threading

import numpy as np
import pytest
import torch

import _torch_batch_workers as workers
from conftest import run_forced_device_subprocess
from repro_torch.chaos import FaultPlan, FaultSpec
from repro_torch.core.su3 import plan as tplan
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import MeshSpec, SlabMesh
from repro_torch.serve.su3 import BatcherConfig, ServiceConfig, SU3Service
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
# name -> (world, hosts, devices per host)
RANKED = {"2 ranks, (2, 2)": (2, 2, 2), "4 ranks, (4, 1)": (4, 4, 1),
          "2 ranks, (4, 1)": (2, 4, 1)}
DEVICE_LISTS = {"cpu x4": [torch.device("cpu")] * 4,
                "cpu:0..3": [torch.device("cpu", i) for i in range(4)]}
TOL = tplan.verify_tolerance("float32")

# The reference's runner and megakernel on its (2, 2) and (4, 1) meshes over
# 4 forced CPU devices (SoA f32, L=4, tile 64), on the inputs saved at
# @INPUTS@; outputs to @OUT@, block maps as [position, lo, hi] in the JSON.
REFERENCE_RUN = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.su3 import plan as jplan
from repro.launch.mesh import MeshSpec

data = np.load("@INPUTS@")
a, b, depths = jnp.asarray(data["a"]), jnp.asarray(data["b"]), data["depths"]
out, maps = {}, {}

def blocks(sharding, shape, mesh):
    order = list(mesh.devices.flat)
    return sorted([order.index(d), *s[0].indices(shape[0])[:2]]
                  for d, s in sharding.devices_indices_map(tuple(shape)).items())

for hosts, dph in ((2, 2), (4, 1)):
    key = f"{hosts}x{dph}"
    r = jplan.BatchedLatticeRunner(jplan.EngineConfig(L=4, tile=64, iterations=1, warmups=0),
                                   MeshSpec(hosts=hosts, devices_per_host=dph))
    for k in (1, 3):
        out[f"{key}/multiply/{k}"] = np.asarray(r.multiply(a, b, k=k))
    a_phys, b_p = r.pack_batch(a), jax.vmap(r.plan.codec.pack_b)(b)
    maps[f"{key}/batch8"] = blocks(r._sharding, (8,) + a_phys.shape[1:], r.mesh)
    c = r.run(a_phys[:4], b_p[:4], k=3)
    maps[f"{key}/run4"] = blocks(c.sharding, c.shape, r.mesh)
    for slots in (4, 3):
        m = r.plan.fused_batched_step(slots, max_k=4)(
            a_phys[:slots], b_p[:slots], jnp.asarray(depths[:slots]))
        out[f"{key}/mega{slots}"] = np.asarray(jax.vmap(
            lambda x: r.plan.codec.unpack(x, 256))(m))
        maps[f"{key}/mega{slots}"] = blocks(m.sharding, m.shape, r.mesh)
np.savez("@OUT@", **out)
print(json.dumps({"devices": len(jax.devices()), "maps": maps}))
"""


def _blocks(blocks) -> list[list[int]]:
    return [[b.index, b.lo, b.hi] for b in blocks]


def _canon(plan, phys: torch.Tensor) -> np.ndarray:
    return torch.stack([plan.codec.unpack(x, workers.L**4) for x in phys]).numpy()


def _one_device(data) -> dict:
    """The port's one-device runner and megakernel on the inputs."""
    a, b = torch.from_numpy(data["a"]), torch.from_numpy(data["b"])
    runner = tplan.BatchedLatticeRunner(workers.config(), "cpu")
    out = {f"multiply/{k}": runner.multiply(a, b, k=k) for k in (1, 3)}
    out["run/3"] = runner.run(runner.pack_batch(a), runner.pack_b_batch(b), k=3)
    table, table_b = runner.pack_batch(a), runner.pack_b_batch(b)
    depths = torch.from_numpy(data["depths"])
    for slots in (4, 3):
        out[f"mega{slots}"] = runner.plan.fused_batched_step(slots, max_k=workers.MAX_K)(
            table[:slots], table_b[:slots], depths[:slots])
    out["plan"] = runner.plan
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess (in a thread), the gloo ranks of every
    configuration and the one-device runner, alongside."""
    d = tmp_path_factory.mktemp("lattice_batches")
    data = workers.inputs()
    np.savez(d / "inputs.npz", **data)
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
    try:
        ranks = {}
        for name, (world, hosts, dph) in RANKED.items():
            out = d / f"w{world}h{hosts}d{dph}"
            out.mkdir()
            workers.spawn_within(workers.batch_rank, world, 300, world, hosts, dph, str(out))
            ranks[name] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
        one = _one_device(data)
    finally:
        thread.join()
    if "error" in ref:
        raise ref["error"]
    ref.update(dict(np.load(d / "reference.npz")))
    return {"data": data, "ranks": ranks, "one": one, "reference": ref}


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * max(1.0, float(np.max(np.abs(want))))


# -- the block map ---------------------------------------------------------------------


def test_the_reference_ran_on_four_devices(runs):
    assert runs["reference"]["json"]["devices"] == 4


@pytest.mark.parametrize("what", ["batch8", "run4", "mega4", "mega3"])
@pytest.mark.parametrize("mesh", MESHES)
def test_block_map_equals_the_reference(runs, mesh, what):
    plan = tplan.build_plan(workers.config(), MeshSpec(*MESHES[mesh]).resolve("cpu"))
    port = {"batch8": lambda: plan.lattice_batch_blocks(8),
            "run4": lambda: plan.lattice_batch_blocks(4),
            "mega4": lambda: plan.slot_table_blocks(4),
            "mega3": lambda: plan.slot_table_blocks(3)}[what]()
    assert _blocks(port) == runs["reference"]["json"]["maps"][f"{mesh}/{what}"]


def test_an_uneven_table_stays_whole_on_the_first_device(runs):
    """Pinned from the reference: a 3-slot table on 4 devices is not
    sharded; it lies whole on the mesh's first device."""
    for mesh in MESHES:
        assert runs["reference"]["json"]["maps"][f"{mesh}/mega3"] == [[0, 0, 3]]


@pytest.mark.parametrize("config", RANKED)
def test_ranks_hold_only_their_blocks(runs, config):
    world, hosts, dph = RANKED[config]
    ranks = runs["ranks"][config]
    mesh = SlabMesh(hosts, dph, torch.device("cpu"))
    want = _blocks(sharding.lattice_batch_blocks(mesh, 8))
    assert [blk.tolist() for r in ranks for blk in r["blocks"]] == want
    per = len(want) // world
    for r, res in enumerate(ranks):
        assert res["blocks"].tolist() == want[r * per:(r + 1) * per]
        assert int(res["local_shape"][0]) == 8 // world  # the rank packed its lattices only


# -- one process over a device list ------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("devices", DEVICE_LISTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_runner_over_a_device_list(runs, mesh, devices, k):
    data, one = runs["data"], runs["one"]
    runner = tplan.BatchedLatticeRunner(
        workers.config(), MeshSpec(*MESHES[mesh]).resolve("cpu", devices=DEVICE_LISTS[devices]))
    a, b = torch.from_numpy(data["a"]), torch.from_numpy(data["b"])
    got = runner.multiply(a, b, k=k)
    assert got.shape[0] == workers.BATCH  # the padding lattices are sliced away
    assert torch.equal(got, one[f"multiply/{k}"])
    _close(got.numpy(), runs["reference"][f"{mesh}/multiply/{k}"])
    packed = runner.pack_batch(a)
    parts = 1 if devices == "cpu x4" else 4
    assert len(packed) == parts if parts > 1 else isinstance(packed, torch.Tensor)
    c = runner.run(packed, runner.pack_b_batch(b), k=k)
    joined = torch.cat(c) if parts > 1 else c
    if k == 3:
        assert torch.equal(joined[:workers.BATCH], one["run/3"])


@pytest.mark.parametrize("slots", [4, 3])
@pytest.mark.parametrize("devices", DEVICE_LISTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_megakernel_over_a_device_list(runs, mesh, devices, slots):
    data, one = runs["data"], runs["one"]
    runner = tplan.BatchedLatticeRunner(
        workers.config(), MeshSpec(*MESHES[mesh]).resolve("cpu", devices=DEVICE_LISTS[devices]))
    plan = runner.plan
    a, b = torch.from_numpy(data["a"][:slots]), torch.from_numpy(data["b"][:slots])
    depths = data["depths"][:slots]
    blocks = plan.slot_table_blocks(slots)
    parts = sharding.device_parts(blocks)
    tables = [torch.stack([runner.pack_lattice(x, p[0].device) for x in a[p[0].lo:p[-1].hi]])
              for p in parts]
    bs = [torch.stack([plan.codec.pack_b(x) for x in b[p[0].lo:p[-1].hi]]) for p in parts]
    ks = [torch.from_numpy(depths[p[0].lo:p[-1].hi]) for p in parts]
    out = plan.fused_batched_step(slots, max_k=workers.MAX_K)(tables, bs, ks)
    assert len(out) == len(parts) == (4 if devices == "cpu:0..3" and slots == 4 else 1)
    got = torch.cat(out)
    assert torch.equal(got, one[f"mega{slots}"])
    _close(_canon(plan, got), runs["reference"][f"{mesh}/mega{slots}"])


# -- ranks ---------------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("config", RANKED)
def test_ranks_runner_equals_one_device(runs, config, k):
    one = runs["one"]
    hosts, dph = RANKED[config][1:]
    ref = runs["reference"][f"{hosts}x{dph}/multiply/{k}"]
    for res in runs["ranks"][config]:
        got = res[f"multiply/{k}"]  # the whole batch on every rank
        np.testing.assert_array_equal(got, one[f"multiply/{k}"].numpy())
        _close(got, ref)
    # each rank's run over its own blocks: the one-device rows
    want = workers.bits(one["run/3"])
    joined = np.concatenate([res["run/3"] for res in runs["ranks"][config]])
    np.testing.assert_array_equal(joined[:workers.BATCH], want)


@pytest.mark.parametrize("config", RANKED)
def test_ranks_megakernel_equals_one_device(runs, config):
    one = runs["one"]
    want4, want3 = workers.bits(one["mega4"]), workers.bits(one["mega3"])
    for res in runs["ranks"][config]:
        lo, hi = res["mega4/range"].tolist()
        np.testing.assert_array_equal(res["mega4"], want4[lo:hi])
        assert res["mega3/blocks"].tolist() == [[0, 0, 3]]  # whole on every rank
        np.testing.assert_array_equal(res["mega3"], want3)
    ranges = [tuple(res["mega4/range"]) for res in runs["ranks"][config]]
    world = RANKED[config][0]
    assert ranges == [(r * 4 // world, (r + 1) * 4 // world) for r in range(world)]


@pytest.mark.parametrize("config", RANKED)
def test_ranks_refuse_a_card_and_uneven_batches(runs, config):
    for res in runs["ranks"][config]:
        on_card, uneven = (str(x) for x in res["refusals"])
        assert on_card.startswith("RuntimeError") and "nccl" in on_card and "gloo" in on_card
        assert uneven.startswith("ValueError") and "batch of 5" in uneven


# -- refusals, padding, the mesh's device list in this process ---------------------------------


def test_padding_is_sliced_and_bad_batches_refused(runs, monkeypatch):
    data = runs["data"]
    runner = tplan.BatchedLatticeRunner(workers.config(), MeshSpec(2, 2).resolve("cpu"))
    a, b = torch.from_numpy(data["a"]), torch.from_numpy(data["b"])
    a_phys = torch.stack([runner.pack_lattice(x, "cpu") for x in a])
    b_p = torch.stack([runner.plan.codec.pack_b(x) for x in b])
    c = runner.run(a_phys, b_p, k=3)  # 5 lattices padded to 8, then sliced
    assert c.shape[0] == workers.BATCH and torch.equal(c, runs["one"]["run/3"])
    with pytest.raises(ValueError, match="batch of 5 lattices"):
        runner.plan.lattice_batch_blocks(5)
    with pytest.raises(ValueError, match="plan capacity"):
        runner.pack_batch(torch.zeros((1, 300, 4, 3, 3), dtype=torch.complex64))
    split = tplan.BatchedLatticeRunner(
        workers.config(), MeshSpec(2, 2).resolve("cpu", devices=DEVICE_LISTS["cpu:0..3"]))
    with pytest.raises(ValueError, match="4 device run"):
        split.run(a_phys, b_p)  # one tensor for blocks on four devices
    with pytest.raises(ValueError, match="needs 4 devices"):
        MeshSpec(2, 2).resolve("cpu", devices=[torch.device("cpu")] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplan.BatchedLatticeRunner(workers.config(), MeshSpec(2, 2))


def test_mesh_device_lists(monkeypatch):
    cpu = torch.device("cpu")
    assert MeshSpec(2, 2).resolve("cpu").devices == (cpu,) * 4
    sub = MeshSpec(2).host_submesh(1, DEVICE_LISTS["cpu:0..3"])
    assert sub.devices == (torch.device("cpu", 2), torch.device("cpu", 3))
    assert sub.device == torch.device("cpu", 2) and sub.n_devices == 2
    with pytest.raises(ValueError, match="holds 4 here, got 2"):
        SlabMesh(2, 2, cpu, devices=(cpu, cpu))
    # the card with no index: the process's cards when it has enough, else repeated
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((4, [0, 1, 2, 3]), (2, None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=cards: n)
        devices = MeshSpec(2, 2).resolve().devices
        assert devices == (tuple(torch.device("cuda", i) for i in want) if want
                           else (torch.device("cuda"),) * 4)


# -- the service ----------------------------------------------------------------------------

SERVICE_MODES = {
    "batch": {},
    "continuous": {"continuous": True},
    "megakernel": {"continuous": True, "megakernel": True},
}


def _stream():
    ops = []
    for i, (L, k) in enumerate([(2, 1), (2, 3), (3, 2), (2, 4), (3, 1), (2, 2), (3, 3)]):
        ops.append(("multiply", workers.su3(L**4, 40 + i), workers.su3(1, 60 + i)[0], k))
    for i in range(3):
        rng = np.random.default_rng(70 + i)
        v = (rng.standard_normal((16, 3)) + 1j * rng.standard_normal((16, 3))).astype(np.complex64)
        ops.append(("stencil", workers.su3(16, 80 + i), v, 1))
    return ops


def _serve(mode: str, device, faults=None, chain_slots: int = 4):
    cfg = ServiceConfig(autotune=False, tile=16, hosts=2, chain_slots=chain_slots,
                        batcher=BatcherConfig(max_batch=4, warm_batch_sizes=(1, 2, 4),
                                              max_queue_depth=32),
                        faults=faults, **SERVICE_MODES[mode])
    svc = SU3Service(cfg, device=device)
    ops = _stream()
    ids = []
    for i, (kind, x, y, k) in enumerate(ops):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        ids.append(svc.submit(x, y, k=k) if kind == "multiply" else svc.submit_stencil(x, y))
        if i == 3:
            svc.step()
            svc.step()
    svc.run_until_drained()
    return svc, [svc.pop_result(i) for i in ids]


@pytest.fixture(scope="module")
def one_device_service():
    return {mode: _serve(mode, "cpu")[1] for mode in SERVICE_MODES}


@pytest.mark.parametrize("devices", DEVICE_LISTS)
@pytest.mark.parametrize("mode", SERVICE_MODES)
def test_service_over_two_hosts_of_two_devices(one_device_service, mode, devices):
    svc, got = _serve(mode, DEVICE_LISTS[devices])
    pool = DEVICE_LISTS[devices]
    assert svc.host_blocks == [pool[:2], pool[2:]]
    assert svc.host_devices == [pool[0], pool[2]]
    for key, runner in svc._pool.items():
        assert runner.mesh.devices == tuple(svc.host_blocks[key[0]])
        assert runner.n_devices == 2
    if mode == "megakernel":
        for _table, arrays in svc._tables.values():
            assert len(arrays.a_parts) == (2 if devices == "cpu:0..3" else 1)
    want = one_device_service[mode]
    assert len(got) == len(want)
    for x, y in zip(got, want):  # multiplies and stencils: the one-device bits
        assert torch.equal(x, y)


def test_service_unsharded_table_stays_on_the_first_device(one_device_service):
    """A 3-slot table does not split over a host's 2 devices: it stays
    whole on the block's first device (the reference's unsharded table)."""
    svc, got = _serve("megakernel", DEVICE_LISTS["cpu:0..3"], chain_slots=3)
    for host, (_table, arrays) in svc._tables.items():
        assert [[b.index, b.lo, b.hi] for p in arrays.parts for b in p] == [[0, 0, 3]]
        assert arrays.parts[0][0].device == svc.host_blocks[host][0]
    _svc, want = _serve("megakernel", "cpu", chain_slots=3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("mode", ["continuous", "megakernel"])
def test_service_rolls_back_on_each_block(one_device_service, mode):
    """A poisoned dispatch over a table split on two devices rolls back and
    retries: every result is the clean one-device run's."""
    plan = FaultPlan(3, {"kernel": FaultSpec(probability=0.5, actions=("nan", "inf"),
                                            max_fires=4)})
    svc, got = _serve(mode, DEVICE_LISTS["cpu:0..3"], faults=plan)
    assert svc._guarded and plan.fired > 0
    for x, y in zip(got, one_device_service[mode]):
        assert torch.equal(x, y)
