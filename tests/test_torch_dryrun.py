"""The port's dry run (``launch/dryrun.py``) and its sharding arithmetic
(``distributed/sharding.py``) on the CPU, against the reference.

* ``CellPolicy``, ``model_flops`` and ``estimate_memory`` equal the
  reference's, integer for integer, for every (arch, shape) cell on a 1 x 1
  mesh and for the reference's dry-run cases on its 16-device ``multi``
  mesh.  The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (a
  forced device count) when it is imported, which would reach every later
  test of the worker, so its side runs in a subprocess, once per mesh.
* ``resolve_spec`` and ``state_spec_for`` equal the reference's rules on an
  abstract (2, 2, 4) mesh for every parameter and state leaf of every arch.
* The reference's four dry-run cases and an inapplicable cell through the
  port's CLI on the CPU (``meta`` tensors: nothing is allocated), and a
  reduced cell's traced flops against the same step run on real CPU
  tensors.
* The fig7 launch with 2 controllers at L=4 over 1 and 2 slabs on the CPU;
  its digest does not depend on the padding; its C within 1e-5 of the
  reference's plan's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.core.su3.engine import EngineConfig as JEngineConfig
from repro.core.su3.plan import build_plan as jbuild_plan
from repro.distributed import sharding as jsharding
from repro.models import registry as jregistry
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.su3.plan import EngineConfig, build_plan
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import common, registry
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ALL_ARCHS for s in SHAPES]
CASES = [  # the reference's tests/test_dryrun_subprocess.py
    ("whisper-tiny", "train_4k", "single"),
    ("xlstm-125m", "decode_32k", "single"),
    ("granite-moe-1b-a400m", "prefill_32k", "multi"),
    ("zamba2-1.2b", "long_500k", "single"),
]

# The reference's side: its policy, model flops and memory model per cell,
# on the mesh its _mesh_for gives for a label over n forced devices.
_CHILD = r"""
import dataclasses, json, os, sys
n, label, cells = int(sys.argv[1]), sys.argv[2], sys.argv[3:]
os.environ["REPRO_XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
from repro.launch import dryrun
from repro.configs import SHAPES, get_config, shape_applicable
from repro.distributed import sharding
from repro.models import registry
mesh = dryrun._mesh_for(label)
rules = sharding.default_rules(mesh)
out = {"mesh": dict(zip(mesh.axis_names, mesh.devices.shape))}
for cell in cells:
    arch, s = cell.split("/")
    cfg, shape = get_config(arch), SHAPES[s]
    if not shape_applicable(cfg, shape)[0]:
        out[cell] = None
        continue
    pol = dryrun.CellPolicy.for_cell(cfg, shape)
    mem = dryrun.estimate_memory(cfg, shape, mesh, rules, pol, registry.get(cfg))
    out[cell] = {"policy": dataclasses.asdict(pol), "model_flops": dryrun.model_flops(cfg, shape),
                 "memory": {k: v for k, v in mem.items() if k != "fits_v5e_16g"}}
print(json.dumps(out))
"""


def _reference_cells(n_devices: int, label: str, cells) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _CHILD, str(n_devices), label,
                          *(f"{a}/{s}" for a, s in cells)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def reference_one_card():
    return _reference_cells(1, "single", CELLS)


@pytest.fixture(scope="module")
def reference_multi():
    return _reference_cells(16, "multi", [(a, s) for a, s, _ in CASES])


def _port_cell(arch: str, shape_name: str, mesh) -> dict | None:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if not shape_applicable(cfg, shape)[0]:
        return None
    policy = dryrun.CellPolicy.for_cell(cfg, shape)
    mem = dryrun.estimate_memory(cfg, shape, mesh, sharding.default_rules(mesh), policy,
                                 registry.get(cfg))
    assert isinstance(mem.pop("fits_h100_80g"), bool)
    return {"policy": dataclasses.asdict(policy), "model_flops": dryrun.model_flops(cfg, shape),
            "memory": mem}


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_memory_model_equals_the_reference_on_one_card(reference_one_card, arch, shape_name):
    """Every cell of the 40: the same policy, model flops and per-device
    bytes (parameters, moments, gradients, residuals, transients, state) on
    the 1 x 1 mesh; inapplicable cells are so in both."""
    assert reference_one_card["mesh"] == dryrun.mesh_for("single").shape == {"data": 1,
                                                                             "model": 1}
    assert _port_cell(arch, shape_name, dryrun.mesh_for("single")) == reference_one_card[
        f"{arch}/{shape_name}"]


@pytest.mark.parametrize("arch,shape_name,_", CASES)
def test_memory_model_equals_the_reference_on_the_multi_mesh(reference_multi, arch, shape_name,
                                                             _):
    """The reference's dry-run cases on its fallback (pod, data, model) =
    (2, 2, 4) mesh of 16 devices: sharded parameters, moments and states."""
    mesh = dryrun.mesh_for("multi")
    assert reference_multi["mesh"] == mesh.shape
    got = _port_cell(arch, shape_name, mesh)
    assert got == reference_multi[f"{arch}/{shape_name}"]
    assert got["memory"]["params_bytes"] < _port_cell(arch, shape_name,
                                                      dryrun.ONE_CARD)["memory"]["params_bytes"]


ABSTRACT = AbstractMesh((2, 2, 4), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_equal_the_reference_on_an_abstract_mesh(arch):
    """``resolve_spec`` for every parameter and ``state_spec_for`` for every
    decode-state leaf (the reference's stacked layout) of ``arch``, with and
    without FSDP and KV sequence sharding, against the reference's rules."""
    mesh = dryrun.MULTI
    cfg, jcfg = get_config(arch), jget_config(arch)
    for fsdp in (True, False):
        rules = sharding.default_rules(mesh, fsdp=fsdp)
        jrules = jsharding.default_rules(ABSTRACT, fsdp=fsdp)
        for _, s in common.tree_leaves(registry.get(cfg).spec(cfg)):
            assert sharding.resolve_spec(s.axes, s.shape, mesh, rules) == tuple(
                jsharding.resolve_spec(s.axes, s.shape, ABSTRACT, jrules))
        state = jregistry.get(jcfg).state_spec(jcfg, 8, 256, jnp.bfloat16)
        for path, sds in common.tree_leaves(state):
            key = common.path_name(path)
            for kv_seq in (False, True):
                assert sharding.state_spec_for(key, sds.shape, mesh, rules,
                                               kv_seq_shard=kv_seq) == tuple(
                    jsharding._state_spec_for(key, sds.shape, ABSTRACT, jrules,
                                              kv_seq_shard=kv_seq)), (key, kv_seq)


@pytest.mark.parametrize("arch,shape_name,mesh", CASES)
def test_cli_runs_the_reference_cases(tmp_path, capsys, arch, shape_name, mesh):
    """The reference's four dry-run cases through the port's CLI: ``[ok]``,
    and a JSON with the reference's fields, positive flops and bytes, the
    H100 roofline's dominant term and the analytic memory."""
    dryrun.main(["--arch", arch, "--shape", shape_name, "--mesh", mesh,
                 "--results-dir", str(tmp_path)])
    assert "[ok]" in capsys.readouterr().out
    result = json.loads((tmp_path / f"{arch}__{shape_name}__{mesh}.json").read_text())
    assert result["status"] == "ok" and result["n_devices"] == (16 if mesh == "multi" else 1)
    r = result["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective") and r["collective_s"] == 0.0
    assert r["hw"] == "h100_sxm" and r["model_flops"] == dryrun.model_flops(
        get_config(arch), SHAPES[shape_name])
    assert result["memory_analytic"]["total_bytes"] > 0 and result["traced_ops"] > 0
    assert result["memory"]["params_bytes"] == _port_cell(arch, shape_name, dryrun.ONE_CARD)[
        "memory"]["params_bytes"]


def test_cli_skips_inapplicable(tmp_path, capsys):
    dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--mesh", "single",
                 "--results-dir", str(tmp_path)])
    assert "[skip]" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_meta_trace_counts_what_a_cpu_step_counts():
    """A reduced qwen3 train cell (B=2, S=64, one chunk pair) traced on
    ``meta`` counts the flops FlopCounterMode counts for the same step on
    real CPU tensors; the kernels' traffic is tallied, not their chunk
    scores, and the plain versions are themselves again after the trace; a
    ``meta`` call of the wrapper gives the output's shape (D = 32, Dv =
    16)."""
    cfg = get_config("qwen3-4b").reduced()
    shape = ShapeConfig("tiny_train", 64, 2, "train")
    counts, meta = dryrun.trace_cell(cfg, shape)
    assert meta["policy"]["microbatches"] == 1
    api = registry.get(cfg)
    params = common.trainable(api.init(torch.Generator().manual_seed(0), cfg))
    opt_cfg = adamw.AdamWConfig()
    batch = registry.make_inputs(cfg, shape, torch.Generator().manual_seed(1))
    batch = {k: v % cfg.vocab_size for k, v in batch.items()}
    with FlopCounterMode(display=False) as flops:
        make_train_step(cfg, opt_cfg)(params, adamw.init(params, opt_cfg), batch)
    assert counts["flops"] == flops.get_total_flops() > 0
    assert counts["params_bytes"] == 4 * common.count_params(params)
    b, s, hq, hkv, d = 2, 64, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = 4 * (2 * b * s * hq * d + 2 * b * s * hkv * d)  # q, out; k, v
    assert counts["attention_bytes"] > 2 * cfg.n_layers * per_layer  # forward, remat, backward
    assert flash_attention.flash_attention_plain.__name__ == "flash_attention_plain"
    assert flash_attention.flash_attention_bwd_plain.__name__ == "flash_attention_bwd_plain"
    q, v = torch.empty((1, 8, 4, 32), device="meta"), torch.empty((1, 8, 4, 16), device="meta")
    out = flash_attention.flash_attention(q, q, v)
    assert out.device.type == "meta" and out.shape == (1, 8, 4, 16)


def test_fig7_launch_on_the_cpu():
    """Two controllers at L=4 over 1 and 2 slabs: every row verified, the
    two slab counts' digests equal (the launcher raises otherwise), rows
    stamped with the controller count."""
    rows = dryrun.su3_fig7_launch(4, (1, 2), None, 2, device="cpu", timeout=240)
    assert [r["name"] for r in rows] == ["fig7_sharded_d1", "fig7_host_scatter_d1",
                                         "fig7_sharded_d2", "fig7_host_scatter_d2"]
    assert all(r["verified"] and r["controllers"] == 2 and r["device"] == "cpu" for r in rows)
    assert [r["hosts"] for r in rows] == [1, 1, 2, 2]


def test_fig7_digest_does_not_depend_on_the_padding():
    """Plans of 1 and 2 slabs and of tiles 128 and 384 pad L=4's 256 sites
    to 256, 256 and 384: the same digest."""
    plans = [build_plan(EngineConfig(L=4, tile=t), MeshSpec(hosts=h).resolve("cpu"))
             for t, h in ((128, 1), (128, 2), (384, 1))]
    assert sorted({p.padded_sites for p in plans}) == [256, 384]
    assert len({dryrun._su3_result_digest(p, seed=3) for p in plans}) == 1


def test_fig7_result_matches_the_reference_plan():
    """C of the fig7 draw through the port's plan (the kernel's plain
    version) against the reference's plan (its versionX einsum) on the same
    numpy inputs: within 1e-5 (f32 sums in another order)."""
    plan = build_plan(EngineConfig(L=4, tile=128), "cpu")
    got = dryrun.su3_result(plan, seed=5)
    jplan = jbuild_plan(JEngineConfig(L=4, variant="versionX", tile=128))
    rng = np.random.default_rng(5)
    n = 4**4
    a = (rng.standard_normal((n, 4, 3, 3)) + 1j * rng.standard_normal((n, 4, 3, 3))).astype(
        "complex64")
    b = (rng.standard_normal((4, 3, 3)) + 1j * rng.standard_normal((4, 3, 3))).astype("complex64")
    a = np.concatenate([a, np.zeros((jplan.padded_sites - n, 4, 3, 3), "complex64")])
    want = np.asarray(jplan.unpack(jplan.step(jplan.codec.pack(jnp.asarray(a)),
                                              jplan.codec.pack_b(jnp.asarray(b)))))
    assert got.shape == want.shape == (n, 4, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
