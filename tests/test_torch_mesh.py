"""The port's device meshes and placements (``launch/mesh.py``,
``distributed/sharding.py``, ``distributed/act_sharding.py``) against the
reference's, on the CPU.

* Every parameter leaf of every arch gets, on the (2, 2), (4, 1), (1, 4)
  and (2, 1, 2) meshes, the placements of the reference's
  ``param_shardings`` PartitionSpec (read off an ``AbstractMesh``: no
  devices, no processes); the AdamW state and the batch likewise.
* ``shard`` is the identity without rules, and for a plain tensor.
* ``make_mesh`` refuses a world of another size, a backend that is not the
  device's, and a call without a process group; ``init_distributed`` does
  not fall back from NCCL to gloo.
* The flash attention on DTensors (``local_map`` over each rank's heads)
  against the one-process call, forward and backward, on 4 gloo ranks: kv
  heads that shard with q's, that do not (a slice, one kv head, MQA, query
  heads that straddle groups), and the data axis alone.  The kernel's plain
  version runs on both sides, on the same heads, so out and every gradient
  are held within 1e-6 of each tensor's max.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.distributed import act_sharding as jact_sharding
from repro.distributed import sharding as jsharding
from repro.models import registry as jregistry
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import act_sharding, sharding
from repro_torch.launch import mesh as meshes
from repro_torch.models import common, registry
from repro_torch.models import attention
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)
import _torch_mesh_workers as workers

MESHES = {  # label -> (shape, axes)
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "pod 2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}


def _placements_of_spec(spec, axes) -> tuple:
    """A reference PartitionSpec as one placement per mesh axis, written
    out independently of the port's ``placements_of``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axes:
        dims = [i for i, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("mesh_label", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_placements_equal_the_reference(arch, mesh_label):
    shape, axes = MESHES[mesh_label]
    jmesh = AbstractMesh(shape, axes)
    mesh = sharding.LogicalMesh(tuple(zip(axes, shape)))
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = jsharding.param_shardings(jregistry.get(jcfg).spec(jcfg), jmesh,
                                     jsharding.default_rules(jmesh))
    got = sharding.param_placements(registry.get(cfg).spec(cfg), mesh,
                                    sharding.default_rules(mesh))
    want_leaves = {p: _placements_of_spec(s.spec, axes) for p, s in common.tree_leaves(want)}
    got_leaves = dict(common.tree_leaves(got))
    assert want_leaves.keys() == got_leaves.keys()
    for path, pl in want_leaves.items():
        assert got_leaves[path] == pl, common.path_name(path)
    opt = sharding.opt_state_placements(got, mesh)
    jopt = jsharding.opt_state_shardings(want, jmesh)
    assert opt["m"] is got and opt["v"] is got
    assert opt["count"] == _placements_of_spec(jopt["count"].spec, axes)


@pytest.mark.parametrize("mesh_label", list(MESHES))
def test_batch_placements_equal_the_reference(mesh_label):
    import jax
    import jax.numpy as jnp

    shape, axes = MESHES[mesh_label]
    jmesh = AbstractMesh(shape, axes)
    mesh = sharding.LogicalMesh(tuple(zip(axes, shape)))
    shapes = {"tokens": (4, 32), "labels": (4, 32), "odd": (3, 32), "patches": (8, 16, 64)}
    want = jsharding.batch_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}, jmesh,
        jsharding.default_rules(jmesh))
    got = sharding.batch_placements(shapes, mesh, sharding.default_rules(mesh))
    for name in shapes:
        assert got[name] == _placements_of_spec(want[name].spec, axes), name


def test_activation_kinds_are_the_reference_kinds():
    """Every kind the port keeps is the reference's, axis for axis."""
    for kind, axes in act_sharding.KINDS.items():
        assert jact_sharding.KINDS[kind] == axes, kind
    mesh = sharding.LogicalMesh.of(data=2, model=4)
    rules = sharding.default_rules(mesh)
    # a 'model' dim that does not divide falls back to replicated
    assert act_sharding.spec_for("bthd", (4, 8, 2, 16), mesh, rules) == ("data",)
    assert act_sharding.spec_for("bthd", (4, 8, 8, 16), mesh, rules) == ("data", None, "model")
    assert act_sharding.spec_for("btd", (3, 8, 16), mesh, rules) == ()


def test_placements_refuse_axes_out_of_order():
    mesh = sharding.LogicalMesh.of(pod=2, data=2, model=2)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.placements_of((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="lacks"):
        sharding.placements_of(("seq",), mesh)


def test_shard_is_the_identity_without_rules():
    x = torch.randn(2, 3, 4)
    assert act_sharding.active() == (None, None)
    for kind in ("btd", "btf", "btv"):
        assert act_sharding.shard(x, kind) is x


@pytest.fixture
def one_rank_world(tmp_path):
    """A gloo world of this one process, torn down after the test."""
    meshes.init_distributed("cpu", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield
    torch.distributed.destroy_process_group()


def test_shard_leaves_plain_tensors_under_rules(one_rank_world):
    mesh = meshes.make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = sharding.default_rules(sharding.logical_mesh(mesh))
    x = torch.randn(2, 3, 4)
    with act_sharding.use_rules(mesh, rules):
        assert act_sharding.shard(x, "btd") is x
        d = sharding.distribute(x, mesh, act_sharding.placements("btd", x.shape))
        assert torch.equal(act_sharding.shard(d, "btv").to_local(), x)
    assert act_sharding.active() == (None, None)


def test_make_mesh_refuses_another_world(one_rank_world):
    with pytest.raises(ValueError, match=r"\(2, 2\) holds 4 devices, the world has 1"):
        meshes.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match=r"\(16, 16\) holds 256 devices, the world has 1"):
        meshes.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) holds 512 devices"):
        meshes.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs nccl"):
        meshes.make_mesh((1, 1), ("data", "model"))  # the card's mesh on a gloo group
    mesh = meshes.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)


def test_meshes_need_a_group_and_nccl_needs_cards(monkeypatch):
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        meshes.make_mesh((1, 1), ("data", "model"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        meshes.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        meshes.init_distributed("cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        meshes.make_mesh((1,), ("data",), device="meta")


def test_flash_attention_on_each_ranks_heads(tmp_path):
    out = str(tmp_path / "attention.npz")
    workers.spawn(workers.attention_rank, 4, 4, out)
    with np.load(out) as z:
        got = dict(z)
    for label, shape, hq, hkv in workers.ATTENTION_CASES:
        assert bool(got[label + "/kv_sharded"]) == (hkv % shape[1] == 0), label
        q, k, v, dout = workers.attention_inputs(hq, hkv)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = attention.flash_attention(*leaves, causal=True, q_chunk=8, kv_chunk=8)
        want.backward(dout)
        for name, w in [("out", want)] + [(f"d{n}", t.grad) for n, t in zip("qkv", leaves)]:
            w = w.detach().numpy()
            err = np.abs(got[f"{label}/{name}"] - w).max() / np.abs(w).max()
            assert err <= 1e-6, (label, name, err)
