"""The port's training substrate against the JAX reference on the CPU:
AdamW (its update and schedule, f32 and bf16 moments), gradient compression,
the token pipeline (bit for bit), and the reference's ``test_substrate.py``
cases mirrored on the port's checkpoints and fault tolerance; then the
port's own training loop: resume from a checkpoint, the loss going down and
the CLI.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: AdamW's elementwise f32 arithmetic runs in the reference's
order, but the global norm sums in another order, so the clip factor (and
every clipped gradient) may differ by an ulp: params within 1e-6 relative;
moments within 1e-6 of each leaf's largest magnitude, since a moment whose
terms cancel carries their rounding (bf16 moments: one bf16 ulp, 2^-8);
the schedule within 1e-6.
"""
import dataclasses
import os

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import PipelineState as JPipelineState
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.data.pipeline import make_train_batch as jmake_train_batch
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
from repro_torch.distributed.fault_tolerance import (
    ElasticMeshPlanner, HeartbeatMonitor, straggler_safe_step_budget,
)
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw, compression
from repro_torch.train import loop
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "qwen3-4b"
SEQ = 16


def _tree(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(7) * scale).astype(np.float32),
                  "d": (rng.standard_normal((3, 2, 4)) * scale).astype(np.float32)}}


def _flat(tree, prefix="") -> dict[str, np.ndarray]:
    """The port's names of a nested tree: sorted keys joined by '/'."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k], np.float32)
    return out


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# -- AdamW ------------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(moments):
    """Five steps on the same grads, params and state; the second step's
    gradients are large enough to clip."""
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=5, moment_dtype=moments)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    params = _torch(_tree(0))
    jstate, state = jadamw.init(jparams, jcfg), adamw.init(params, cfg)
    tol = 1e-6 if moments == "float32" else 2.0**-8
    for step in range(5):
        grads = _tree(10 + step, scale=5.0 if step == 1 else 0.1)
        jparams, jstate, jm = jadamw.update(jax.tree.map(jnp.asarray, grads), jstate, jparams,
                                            jcfg)
        params, state, m = adamw.update(_torch(grads), state, params, cfg)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
        got = adamw.named_leaves(params)
        for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            for name, want in _flat(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                 jstate[key])).items():
                assert state[key][name].dtype == getattr(torch, moments)
                err = np.abs(state[key][name].float().numpy() - want).max()
                assert err <= tol * np.abs(want).max(), (step, key, name, err)
    assert int(state["count"]) == int(jstate["count"]) == 5


def test_adamw_schedule_equals_the_reference_at_every_step():
    cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=7, total_steps=50, min_lr_ratio=0.1)
    jcfg = jadamw.AdamWConfig(**dataclasses.asdict(cfg))
    for s in range(0, 60):
        np.testing.assert_allclose(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)).item(),
                                   float(jadamw.schedule(jcfg, jnp.int32(s))), rtol=1e-6, atol=0)


def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=100, weight_decay=0.0)
    params = {"w": torch.ones(8) * 5.0}
    state = adamw.init(params, cfg)
    for _ in range(60):
        grads = {"w": params["w"].clone()}  # d/dw 0.5*w^2
        params, state, _ = adamw.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_schedule_shape_and_grad_clip():
    cfg = adamw.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(cfg, s)) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    clip = adamw.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    _, _, m = adamw.update({"w": torch.ones(4) * 100.0}, adamw.init(params, clip), params, clip)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_adamw_update_reads_grads_only_and_walks_chunks(monkeypatch):
    """Leaves larger than a chunk update slice by slice, with the same bits
    as in one piece; the gradients are left as they were."""
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    grads = _torch(_tree(3))
    kept = {k: v.clone() for k, v in adamw.named_leaves(grads).items()}
    whole, sliced = _torch(_tree(4)), _torch(_tree(4))
    adamw.update(grads, adamw.init(whole, cfg), whole, cfg)
    monkeypatch.setattr(adamw, "CHUNK", 5)
    adamw.update(grads, adamw.init(sliced, cfg), sliced, cfg)
    for name, g in adamw.named_leaves(grads).items():
        assert torch.equal(g, kept[name])
        assert torch.equal(adamw.named_leaves(whole)[name], adamw.named_leaves(sliced)[name])


# -- compression -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_equals_the_reference(mode):
    cfg = compression.CompressionConfig(mode=mode)
    jcfg = jcompression.CompressionConfig(mode=mode)
    params = _tree(0)
    jerr = jcompression.init_error_state(jax.tree.map(jnp.asarray, params), jcfg)
    err = compression.init_error_state(_torch(params), cfg)
    for step in range(4):
        g = _tree(20 + step)
        jg, jerr, jm = jcompression.apply_error_feedback(jax.tree.map(jnp.asarray, g), jerr, jcfg)
        tg, err, m = compression.apply_error_feedback(_torch(g), err, cfg)
        for name, want in _flat(jax.tree.map(np.asarray, jg)).items():
            np.testing.assert_allclose(tg[name].numpy(), want, rtol=1e-6, atol=1e-7)
        for name, want in _flat(jax.tree.map(np.asarray, jerr)).items():
            np.testing.assert_allclose(err[name].numpy(), want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(m["compression_err"].item(), float(jm["compression_err"]),
                                   rtol=1e-5)
    wire, scale = compression.compress(torch.tensor([1.0, -3.0, 0.5]), mode)
    assert wire.dtype == (torch.bfloat16 if mode == "bf16" else torch.int8)
    with pytest.raises(ValueError):
        compression.compress(torch.zeros(2), "fp4")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_error_feedback_bounded(mode):
    """EF keeps the accumulated error bounded across steps."""
    cfg = compression.CompressionConfig(mode=mode)
    err = compression.init_error_state({"w": torch.zeros(64)}, cfg)
    rng = np.random.default_rng(0)
    errs = []
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
        _, err, m = compression.apply_error_feedback(g, err, cfg)
        errs.append(float(m["compression_err"]))
    assert errs[-1] < 10 * (np.mean(errs[:10]) + 1e-6)


def test_compression_preserves_mean_signal():
    """sum over steps of compressed grads ~= sum of true grads (EF property)."""
    cfg = compression.CompressionConfig(mode="int8")
    err = compression.init_error_state({"w": torch.zeros(16)}, cfg)
    rng = np.random.default_rng(1)
    tot_true, tot_comp = np.zeros(16), np.zeros(16)
    for _ in range(100):
        g = rng.normal(size=16).astype(np.float32)
        tot_true += g
        g2, err, _ = compression.apply_error_feedback({"w": torch.from_numpy(g)}, err, cfg)
        tot_comp += g2["w"].numpy()
    np.testing.assert_allclose(tot_comp, tot_true, atol=0.2)
    none = compression.CompressionConfig()
    assert compression.init_error_state({"w": torch.zeros(2)}, none) is None


# -- the token pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 4])
def test_pipeline_batches_equal_the_reference_bitwise(shards):
    cfg, jcfg = DataConfig(100, 12, 8, seed=3), JDataConfig(100, 12, 8, seed=3)
    for i in range(shards):
        mine = TokenPipeline(cfg, shard_index=i, shard_count=shards)
        ref = JTokenPipeline(jcfg, shard_index=i, shard_count=shards)
        for step in (0, 5):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for key in ("tokens", "labels", "labels2"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype
    full = TokenPipeline(cfg).batch_at(3)["tokens"]
    parts = [TokenPipeline(cfg, shard_index=i, shard_count=4).batch_at(3)["tokens"]
             for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), full)


def test_make_train_batch_equals_the_reference():
    for mtp in (0, 1):
        cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), mtp_depth=mtp)
        jcfg = dataclasses.replace(jget_config("qwen3-4b").reduced(), mtp_depth=mtp)
        dcfg = DataConfig(cfg.vocab_size, SEQ, 2, seed=1)
        got, state = make_train_batch(TokenPipeline(dcfg), PipelineState(step=4), cfg)
        want, jstate = jmake_train_batch(
            JTokenPipeline(JDataConfig(cfg.vocab_size, SEQ, 2, seed=1)), JPipelineState(step=4),
            jcfg)
        assert set(got) == set(want) and state.step == jstate.step == 5
        for key in want:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    vlm = get_config("internvl2-26b").reduced()
    batch, _ = make_train_batch(TokenPipeline(DataConfig(vlm.vocab_size, SEQ, 2)),
                                PipelineState(), vlm)
    again, _ = make_train_batch(TokenPipeline(DataConfig(vlm.vocab_size, SEQ, 2)),
                                PipelineState(), vlm)
    assert batch["patches"].shape == (2, vlm.n_patches, vlm.d_model)
    assert torch.equal(batch["patches"], again["patches"])


def test_pipeline_labels_shift():
    b = TokenPipeline(DataConfig(vocab_size=50, seq_len=12, global_batch=2, seed=1)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    np.testing.assert_array_equal(b["labels"][:, 1:], b["labels2"][:, :-1])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(DataConfig(50, 12, 6), shard_count=4)


@hypothesis.settings(deadline=None, max_examples=10)
@hypothesis.given(step=st.integers(0, 1000))
def test_pipeline_markov_structure(step):
    """every token is a legal successor of its predecessor."""
    p = TokenPipeline(DataConfig(vocab_size=64, seq_len=32, global_batch=1, seed=5, branching=4))
    toks = p.batch_at(step)["tokens"][0]
    for t in range(1, len(toks)):
        assert toks[t] in p._succ[toks[t - 1]]


# -- checkpoints ----------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2, async_save=False))
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 3)),
                                        "h": torch.full((3,), 1.5, dtype=torch.bfloat16)}}
    for s in (1, 2, 3):
        mgr.save(s, {"a": tree["a"] * s, "b": {k: v * s for k, v in tree["b"].items()}},
                 {"pipeline_step": s * 10})
    assert mgr.all_steps() == [2, 3]  # retention pruned step 1
    restored, extra, step = mgr.restore(tree)
    assert restored is tree and step == 3 and extra["pipeline_step"] == 30
    np.testing.assert_array_equal(tree["a"].numpy(), np.arange(5) * 3)
    assert tree["b"]["h"].dtype == torch.bfloat16 and torch.equal(
        tree["b"]["h"], torch.full((3,), 4.5, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": torch.arange(5)})
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"a": torch.arange(6), "b": tree["b"]})


def test_checkpoint_ignores_partial(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    mgr.save(5, {"a": torch.ones(3)})
    (tmp_path / "step_00000009").mkdir()  # a crashed writer: no manifest
    assert mgr.latest_step() == 5
    (tmp_path / "step_00000011.tmp").mkdir()  # and a .tmp leftover
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        CheckpointManager(CheckpointConfig(str(tmp_path / "empty"))).restore({})


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=True))
    x = torch.zeros(10)
    mgr.save(1, {"a": x})
    x += 1  # the snapshot was taken before save returned
    mgr.wait()
    assert mgr.latest_step() == 1
    assert sorted(os.listdir(tmp_path / "step_00000001")) == ["arrays.npz", "manifest.json"]
    mgr.restore({"a": x})
    assert torch.equal(x, torch.zeros(10))


# -- fault tolerance --------------------------------------------------------------------------


def test_heartbeat_dead_and_stragglers():
    mon = HeartbeatMonitor(["h0", "h1", "h2"], deadline_s=10, straggler_factor=2.0)
    now = 1000.0
    for _ in range(21):  # converge EWMA
        mon.beat("h0", 1.0, now=now)
        mon.beat("h1", 1.1, now=now)
        mon.beat("h2", 5.0, now=now)
    assert mon.stragglers() == ["h2"]
    assert mon.dead(now=now + 11)[0:3] == ["h0", "h1", "h2"]
    mon.beat("h0", now=now + 11)
    assert "h0" not in mon.dead(now=now + 11)


def test_elastic_mesh_planner():
    p = ElasticMeshPlanner(devices_per_host=4, model_axis=16, global_batch=256)
    plan = p.plan(alive_hosts=[f"h{i}" for i in range(60)], dead_hosts=["h60", "h61"])
    assert plan.n_devices <= 240
    assert plan.model == 16  # model axis preserved
    assert 256 % plan.data == 0
    plan2 = p.plan(alive_hosts=["h0", "h1"], dead_hosts=[])  # the model axis must shrink
    assert plan2.model <= 8 and plan2.n_devices == 8


def test_straggler_budget():
    assert straggler_safe_step_budget([1.0, 1.1, 0.9], 2.0) == pytest.approx(2.0)
    assert straggler_safe_step_budget([]) == float("inf")


# -- the port's training loop -------------------------------------------------------------------


def _short(tmp, steps, **kw):
    return loop.TrainConfig(steps=steps, seq_len=SEQ, global_batch=2, log_every=1,
                            checkpoint_dir=tmp, checkpoint_every=100,
                            opt=adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4),
                            **kw)


def test_train_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    cfg = get_config(ARCH).reduced()
    quiet = lambda s: None  # noqa: E731
    straight = loop.train(cfg, _short(None, 4), log=quiet, device="cpu")
    first = loop.train(cfg, _short(str(tmp_path), 2), log=quiet, device="cpu")
    logs = []
    resumed = loop.train(cfg, _short(str(tmp_path), 4), log=logs.append, device="cpu")
    assert logs[0] == "restored checkpoint at step 2"
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    assert [h["loss"] for h in first["history"] + resumed["history"]] == \
        [h["loss"] for h in straight["history"]]
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(straight["opt_state"]["v"]["embed"], resumed["opt_state"]["v"]["embed"])


def test_train_loss_decreases_dense():
    """As the reference's test_train_loss_decreases_dense: 160 steps give a
    >0.1-nat margin over the Markov data's learnable structure."""
    cfg = get_config(ARCH).reduced()
    tcfg = loop.TrainConfig(steps=160, seq_len=64, global_batch=4, log_every=40,
                            opt=adamw.AdamWConfig(peak_lr=5e-3, warmup_steps=6,
                                                  total_steps=160, weight_decay=0.0))
    out = loop.train(cfg, tcfg, log=lambda s: None, device="cpu")
    assert len(out["losses"]) == 4 and out["losses"][-1] < out["losses"][0], out["losses"]
    assert len(out["step_ms"]) == 160


def test_train_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(get_config(ARCH).reduced(), loop.TrainConfig(steps=1), log=lambda s: None)


def test_train_cli_on_the_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done; final loss" in out
