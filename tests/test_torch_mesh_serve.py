"""Serving on the port's (data, model) mesh: ``ServeEngine(..., mesh=)``
over 4 gloo ranks on (2, 2) for qwen3-4b, granite-moe-1b-a400m and
deepseek-v3-671b (reduced, f32 weights and caches), prefill and 4 greedy
decode steps, against the reference's jitted ``prefill`` and
``decode_step`` on its forced 2 x 2 CPU mesh (``in_shardings=(p_sh, b_sh,
s_sh)``, the state at ``state_shardings``, as its ``lower_cell`` builds
them), against the port's one process, and on a (1, 1) mesh bitwise
against that one process.

Tolerances: each call's last-position logits within 1e-4 of their max
(f32; sums in another order: XLA's against torch's, partial sums over the
model axis, the MoE combine's per-rank sums), the greedy tokens equal.
Every cache leaf lies at the reference's ``state_shardings`` spec (the
port keeps one cache per layer where the reference stacks them: the
stacked spec without its layer dim), and each rank holds only its shard
(``local_numel`` elements).  Weights: ``_torch_mesh_family_workers.init_tree``.
"""
import concurrent.futures
import json

import numpy as np
import pytest

import _torch_mesh_family_checks as checks
import _torch_mesh_family_workers as fw
import _torch_mesh_workers as workers
from conftest import run_forced_device_subprocess
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.models import registry
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

AXES = ("data", "model")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference's serving on its 2 x 2 mesh (beside the ranks), the
    port's on 4 gloo ranks (2, 2) and one (1, 1), and in one process."""
    d = tmp_path_factory.mktemp("mesh_serve")
    for arch in fw.SERVE_ARCHS:
        workers.save_tree(d / f"{arch}.init.npz", fw.init_tree(arch))
    code = fw.REFERENCE_SERVE.format(archs=list(fw.SERVE_ARCHS), shape=fw.SERVE_MESH, out=str(d),
                                     batch=fw.SERVE_BATCH, prompt=fw.SERVE_PROMPT,
                                     steps=fw.SERVE_STEPS, max_len=fw.SERVE_MAX_LEN,
                                     kv_seq_shard=False, suffix="")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_forced_device_subprocess, code, timeout=600)
        workers.spawn(fw.serve_rank, 4, 4, list(fw.SERVE_ARCHS), fw.SERVE_MESH, str(d), str(d))
        workers.spawn(fw.serve_rank, 1, 1, list(fw.SERVE_ARCHS), (1, 1), str(d), str(d))
        one = {arch: fw.serve_one_process(arch, str(d / f"{arch}.init.npz"))
               for arch in fw.SERVE_ARCHS}
        ref = ref.result()
    return {"dir": str(d), "ref": ref, "one": one}


def _port(served, arch, shape) -> dict:
    with np.load(fw.tag(served["dir"], arch, shape) + ".serve.npz") as z:
        return dict(z)


def _reference(served, arch) -> dict:
    stem = fw.tag(served["dir"], arch, fw.SERVE_MESH)
    with np.load(stem + ".ref_serve.npz") as z:
        out = dict(z)
    out.update(served["ref"][stem])
    return out


@pytest.mark.parametrize("arch", fw.SERVE_ARCHS)
def test_mesh_serving_matches_the_reference(served, arch):
    got, ref = _port(served, arch, fw.SERVE_MESH), _reference(served, arch)
    checks.assert_logits_close(got["logits"], ref["logits"])
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    prompts = fw.serve_prompts(get_config(arch).reduced())
    np.testing.assert_array_equal(got["generated"],
                                  np.concatenate([prompts, got["tokens"]], axis=1))


@pytest.mark.parametrize("arch", fw.SERVE_ARCHS)
def test_mesh_serving_matches_the_one_process(served, arch):
    got, one = _port(served, arch, fw.SERVE_MESH), served["one"][arch]
    checks.assert_logits_close(got["logits"], one["logits"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


@pytest.mark.parametrize("arch", fw.SERVE_ARCHS)
def test_one_rank_mesh_serving_is_bitwise_the_one_process(served, arch):
    got, one = _port(served, arch, (1, 1)), served["one"][arch]
    np.testing.assert_array_equal(got["logits"], one["logits"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


@pytest.mark.parametrize("arch", fw.SERVE_ARCHS)
def test_cache_leaves_keep_the_reference_placements_and_only_their_shards(served, arch):
    """Every cache leaf of every rank after prefill and decode: at the
    reference's ``state_shardings`` spec of its stack (without the layer
    dim), holding ``local_numel`` elements; the reference's jitted calls
    kept their state at that spec too."""
    ref = _reference(served, arch)
    assert ref["state_out"] == ref["state_specs"]
    lm = sharding.LogicalMesh(tuple(zip(AXES, fw.SERVE_MESH)))
    sharded = 0
    for rank in range(4):
        with open(fw.tag(served["dir"], arch, fw.SERVE_MESH) + f".cache.rank{rank}.json") as f:
            cache = json.load(f)
        cfg = get_config(arch).reduced()
        n_layers = sum(registry.get(cfg).stack_sizes(cfg).values())
        assert len(cache) == 2 * n_layers
        for name, leaf in cache.items():
            stack, _, last = name.split("/")
            spec = ref["state_specs"][f"{stack}/{last}"]
            assert spec[0] is None  # the reference's layer dim
            layer_spec = tuple(spec[1:])
            assert leaf["placements"] == str(checks.spec_placements(layer_spec)), (rank, name)
            shape = tuple(leaf["shape"])
            assert leaf["local_numel"] == sharding.local_numel(
                shape, tuple(tuple(e) if isinstance(e, list) else e for e in layer_spec), lm)
            sharded += leaf["local_numel"] < int(np.prod(shape))
    assert sharded == 4 * len(cache)  # batch rows over data at least: no rank holds a whole cache
    if arch != "deepseek-v3-671b":  # GQA caches: kv heads over model too
        k_spec = ref["state_specs"][next(k for k in ref["state_specs"] if k.endswith("/k"))]
        assert k_spec[3] == "model"
    else:  # MLA latents: batch over data only, whole over model
        assert all(s[2:] in ([], [None], [None, None]) for s in ref["state_specs"].values())
