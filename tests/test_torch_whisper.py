"""The port's whisper encoder-decoder against the JAX reference on the CPU:
the sinusoid, the encoder, non-causal attention at whisper-tiny's
cross-attention shape, and whisper-tiny's reduced model (2 encoder layers
over 64 frames, 4 decoder layers, 4 heads of 32): the loss and every
gradient, prefill logits and every cache leaf (self and cross K/V),
decode, greedy serving, a train step with AdamW, the weight carry
(``enc_layers`` and ``dec_layers`` stacked), remat, training resumed
bitwise, and both CLIs.

Every input is made with numpy from a seed; the model's weights are a
numpy tree (``_tree``) carried by ``registry.params_from_reference``.  The
reference's attention on the CPU is its chunked jnp function
(``repro.models.attention.flash_attention``), not the Pallas kernel.

Tolerances, f32: sums in another order (XLA's against torch's, the chunked
attention's chunks), ~1e-7 relative per op: the encoder within 1e-5 of its
output's max; logits within 1e-4; cache leaves within 1e-5 of each one's
max; losses within 1e-5 relative; gradients within 1e-3 of each leaf's
largest magnitude (an element near zero carries the rounding of the terms
that cancelled in it); after one AdamW step the moments as the gradients,
the parameters as ``test_whisper_train_step_equals_the_reference`` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import PipelineState, TokenPipeline, make_train_batch
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, common, registry, whisper
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import loop, train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "whisper-tiny"
SEQ, BATCH = 16, 2


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_sinusoid_equals_the_reference():
    """The positions' table at whisper-tiny's width over its 1,500 frames,
    and at the reduced width.  Both packages form the same f32 exponents
    (bitwise); XLA's f32 ``exp`` and torch's part by one ulp (2^-24
    relative) on some frequencies (19 of 192 here), and a frequency f <= 1
    off by one ulp moves the angle at position p by p f 2^-24: so the
    tables agree within 2 n 2^-24 + 1e-6 absolute over n positions (1.8e-4
    at 1,500; the sin and cos of equal angles agree within 6e-8)."""
    for d, n in ((384, 1500), (128, 64)):
        want = np.asarray(jwhisper._sinusoid(jnp.arange(n), d))
        got = whisper._sinusoid(torch.arange(n), d).numpy()
        assert got.shape == want.shape == (n, d)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * n * 2.0**-24 + 1e-6)
    pos = whisper._sinusoid(torch.full((2, 1), 37.0), 128)
    np.testing.assert_allclose(pos.numpy(), np.asarray(
        jwhisper._sinusoid(jnp.int32(37)[None] + jnp.zeros((2, 1)), 128)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sq", [7, 33])
def test_cross_attention_over_1500_frames_equals_the_reference(sq):
    """Non-causal attention at whisper-tiny's cross-attention shape (6 heads
    of 64, G = 1, Skv = 1,500, a ragged 1,500 = 2 x 512 + 476 against the
    chunks): the port's plain version against the reference's chunked
    function, within 1e-5 of the output's max."""
    q, k, v = _normal(1, 2, sq, 6, 64), _normal(2, 2, 1500, 6, 64), _normal(3, 2, 1500, 6, 64)
    want = jattention.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                                    kv_chunk=512)
    assert _max_err(got.numpy(), want) <= 1e-5


# -- whisper-tiny reduced ----------------------------------------------------------------------


def _tree(cfg, seed: int) -> dict:
    """The reference's tree with numpy weights: zeros, ones, or
    ``scale * N(0, 1)`` with the spec's scale, else 0.05.  (The reference's
    init takes 1/sqrt(shape[0]), the layer count for a stacked leaf: std
    0.5-0.7 here, attention logits in the hundreds, a saturated softmax
    whose near-ties amplify f32 rounding.  At 0.05 activations stay O(1).)"""
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(whisper.spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = (rng.standard_normal(s.shape) * (s.scale or 0.05)).astype(np.float32)
        common.tree_set(tree, path, x)
    return tree


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port model), the same weights."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _tree(cfg, 0)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, registry.params_from_reference(cfg, tree)


def _frames(seed: int, cfg, batch: int = BATCH) -> np.ndarray:
    return _normal(seed, batch, cfg.encoder_len, cfg.d_model)


def _batch(cfg, step: int = 0, seq: int = SEQ, batch: int = BATCH):
    raw = JTokenPipeline(JDataConfig(512, seq, batch, seed=0)).batch_at(step)
    frames = _frames(100 + step, cfg, batch)
    tb = {k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    return dict(tb, frames=torch.from_numpy(frames)), dict(jb, frames=jnp.asarray(frames))


def test_registry_returns_whisper_and_the_reduced_shape(carried):
    _, _, cfg, model = carried
    api = registry.get(cfg)
    assert api is registry._WHISPER and api.loss_fn is whisper.loss_fn
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.encoder_len) == (2, 4, 64)
    assert len(model["enc_layers"]) == 2 and len(model["dec_layers"]) == 4
    assert api.stack_sizes(cfg) == {"enc_layers": 2, "dec_layers": 4}


def test_whisper_tree_and_weight_carry(carried):
    """Every leaf is carried (both stacks split per layer and stacked back)
    and the carry round-trips exactly."""
    jcfg, jparams, cfg, model = carried
    tree = jax.tree.map(np.asarray, jparams)
    assert [p for p, _ in common.tree_leaves(tree)] == \
        [p for p, _ in common.tree_leaves(jregistry.get(jcfg).spec(jcfg))]
    assert common.count_params(model) == sum(int(x.size) for x in jax.tree.leaves(jparams))
    back = registry.params_to_reference(cfg, model)
    got, want = common.tree_leaves(back), common.tree_leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=common.path_name(path))
    np.testing.assert_array_equal(model["dec_layers"][3]["cross"]["wq"].numpy(),
                                  tree["dec_layers"]["cross"]["wq"][3])
    named = dict(model.named_parameters())
    del named["enc_layers.1.ffn.b_in"]
    with pytest.raises(ValueError, match="no leaf named enc_layers.1.ffn.b_in"):
        registry.params_to_reference(cfg, named)
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, dict(tree, stray=np.zeros(3, np.float32)))


def test_whisper_encode_equals_the_reference(carried):
    """The encoder over 64 frames: non-causal attention, GELU FFN, final norm."""
    jcfg, jparams, cfg, model = carried
    frames = _frames(3, cfg)
    want = jwhisper.encode(jparams, jnp.asarray(frames), jcfg)
    got = whisper.encode(model, torch.from_numpy(frames), cfg, q_chunk=16, kv_chunk=16)
    assert got.shape == want.shape == (2, 64, cfg.d_model)
    assert _max_err(got.numpy(), want) <= 1e-5


def test_whisper_loss_and_gradients_equal_the_reference(carried):
    """Every gradient, both stacks' and the embedding's."""
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch(cfg)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=8, kv_chunk=16),
        has_aux=True))(jparams, jb)
    model = common.trainable(model)
    try:
        grads, metrics = train_step.make_grad_fn(cfg, q_chunk=8, kv_chunk=16)(model, tb)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jm) == {"nll", "loss"}
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jgrads)):
        assert _max_err(got[path], w) <= 1e-3, common.path_name(path)
    assert np.any(got[("enc_layers", "attn", "wq")])


def test_whisper_prefill_decode_and_caches_equal_the_reference(carried):
    """Prefill (the frames and 11 tokens), then 4 decode steps: logits and
    every cache leaf (the cross K/V filled once in prefill)."""
    jcfg, jparams, cfg, model = carried
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 15), dtype=np.int32)
    frames = _frames(4, cfg)
    jstate = jwhisper.init_state(jcfg, 2, 24, jnp.float32)
    tstate = whisper.init_state(cfg, 2, 24, torch.float32)
    assert {k: tuple(v.shape) for k, v in tstate.items()} == \
        {k: v.shape for k, v in jstate.items()}
    jl, jstate = jwhisper.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11]),
                                            "frames": jnp.asarray(frames)}, jstate, jcfg)
    tl, out = whisper.prefill(model, {"tokens": torch.from_numpy(toks[:, :11]),
                                      "frames": torch.from_numpy(frames)}, tstate, cfg,
                              q_chunk=8, kv_chunk=16)
    steps = [(jl, tl)]
    for t in range(11, 15):
        jl, jstate = jwhisper.decode_step(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                          jstate, jnp.int32(t), jcfg)
        tl, out = whisper.decode_step(model, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                      out, t, cfg)
        steps.append((jl, tl))
    assert out is tstate
    for i, (j, t) in enumerate(steps):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4, err_msg=str(i))
    for name in tstate:
        assert _max_err(tstate[name].numpy(), jstate[name]) <= 1e-5, name
    assert not torch.any(tstate["self_k"][:, :, 15:])


def test_whisper_decode_steps_one_token_only(carried):
    _, _, cfg, model = carried
    state = whisper.init_state(cfg, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="one token per row, got 2"):
        whisper.decode_step(model, {"tokens": torch.zeros((1, 2), dtype=torch.int32)}, state,
                            0, cfg)


def test_whisper_decode_matches_teacher_forcing(carried):
    """Decode logits against one cache-less pass over the prompt and the
    consumed tokens (teacher forcing), on the same frames."""
    _, _, cfg, model = carried
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 14),
                                                              dtype=np.int32))
    frames = torch.from_numpy(_frames(7, cfg))
    state = whisper.init_state(cfg, 2, 16, torch.float32)
    lg, state = whisper.prefill(model, {"tokens": toks[:, :10], "frames": frames}, state, cfg)
    served = [lg]
    for t in range(10, 14):
        lg, state = whisper.decode_step(model, {"tokens": toks[:, t:t + 1]}, state, t, cfg)
        served.append(lg)
    x = whisper.forward_train(model, {"tokens": toks, "frames": frames}, cfg)
    teacher = whisper._logits(model, x, cfg)[:, 9:]
    torch.testing.assert_close(torch.cat(served, 1), teacher, rtol=1e-4, atol=1e-4)


def test_whisper_serve_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    frames = _frames(8, cfg)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(
        prompts, 6, extras={"frames": jnp.asarray(frames)})
    eng = ServeEngine(cfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(prompts, 6, extras={"frames": frames})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6, extras={"frames": frames}), got)


def test_whisper_train_step_equals_the_reference():
    """One AdamW step: the loss, grad norm and lr are the reference's, and
    so are the updated parameters and moments."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _tree(cfg, 1)
    jparams, model = jax.tree.map(jnp.asarray, tree), common.trainable(
        registry.params_from_reference(cfg, tree))
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(cfg, 1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=8,
                                                               kv_chunk=16))(
        jparams, jadamw.init(jparams, jopt), jb)
    step = train_step.make_train_step(cfg, opt, q_chunk=8, kv_chunk=16)
    model, state, m = step(model, adamw.init(model, opt), tb)
    assert set(m) == set(jm) == {"loss", "nll", "grad_norm", "lr"}
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for k in ("m", "v"):  # the moments follow the gradients: 1e-3 of each leaf's max
        mine = dict(common.tree_leaves(registry.params_to_reference(cfg, state[k])))
        for path, w in common.tree_leaves(jax.tree.map(np.asarray, jstate[k])):
            assert _max_err(mine[path], w) <= 1e-3, (k, common.path_name(path))
    # Adam's first step moves a parameter by ~lr whatever |g|, except where
    # |g| is near eps = 1e-8: every parameter within 2 lr of the
    # reference's, all but 1e-4 of a leaf's within 1e-5 (1% of lr)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, model)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jparams2)):
        off = np.abs(got[path] - w)
        assert off.max() <= 2 * opt.peak_lr and np.mean(off > 1e-5) <= 1e-4, \
            common.path_name(path)


def test_whisper_remat_gives_bitwise_equal_gradients(carried):
    """Recomputing each decoder layer in the backward changes no bit."""
    _, _, cfg, model = carried
    tb, _ = _batch(cfg, 2)
    model = common.trainable(model)
    try:
        runs = [train_step.make_grad_fn(cfg, remat=remat, q_chunk=8, kv_chunk=16)(model, tb)
                for remat in (True, False)]
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    (g_remat, m_remat), (g_plain, m_plain) = runs
    assert torch.equal(m_remat["loss"], m_plain["loss"])
    for name, g in g_remat.items():
        assert torch.equal(g, g_plain[name]), name


def _short(tmp, steps):
    return loop.TrainConfig(steps=steps, seq_len=SEQ, global_batch=2, log_every=1,
                            checkpoint_dir=tmp, checkpoint_every=100,
                            opt=adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4))


def test_whisper_train_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Mirrors tests/test_train_serve_e2e.py::test_train_resume_continues_exactly
    on whisper, bitwise (the frames come from the pipeline's seeded stream,
    so the resumed run draws the same ones)."""
    cfg = get_config(ARCH).reduced()
    quiet = lambda s: None  # noqa: E731
    straight = loop.train(cfg, _short(None, 4), log=quiet, device="cpu")
    first = loop.train(cfg, _short(str(tmp_path), 2), log=quiet, device="cpu")
    resumed = loop.train(cfg, _short(str(tmp_path), 4), log=quiet, device="cpu")
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    hist = first["history"] + resumed["history"]
    for key in ("loss", "nll", "grad_norm"):
        assert [h[key] for h in hist] == [h[key] for h in straight["history"]]
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, a in straight["opt_state"][k].items():
            assert torch.equal(a, resumed["opt_state"][k][n]), (k, n)


def test_whisper_train_batches_carry_frames():
    """The data pipeline draws each step's frames from its seeded stream:
    (B, encoder_len, d_model) in the model's dtype, the same for a step
    whenever and wherever it is drawn, another for the next step."""
    cfg = get_config(ARCH).reduced()
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SEQ, 2, seed=0))
    a, nxt = make_train_batch(pipe, PipelineState(step=3), cfg)
    b, _ = make_train_batch(pipe, PipelineState(step=3), cfg)
    c, _ = make_train_batch(pipe, nxt, cfg)
    assert a["frames"].shape == (2, cfg.encoder_len, cfg.d_model)
    assert a["frames"].dtype == torch.float32
    assert torch.equal(a["frames"], b["frames"]) and not torch.equal(a["frames"], c["frames"])
    # drawn by a CPU generator whatever the device, so the card trains on these numbers too
    want = torch.randn((2, cfg.encoder_len, cfg.d_model),
                       generator=torch.Generator().manual_seed(18 * 1_000_003 + 3))
    assert torch.equal(a["frames"], want)


# -- mirrors of whisper's cases in tests/test_arch_smoke.py ----------------------------------


def test_whisper_train_step_smoke():
    """Mirrors tests/test_arch_smoke.py::test_train_step_smoke[whisper-tiny]."""
    cfg = get_config(ARCH).reduced()
    api = registry.get(cfg)
    params = common.trainable(api.init(torch.Generator().manual_seed(0), cfg))
    batch = registry.make_inputs(cfg, ShapeConfig("smoke", 32, 2, "train"),
                                 torch.Generator().manual_seed(1))
    assert batch["frames"].shape == (2, 64, cfg.d_model)
    loss, _ = api.loss_fn(params, batch, cfg, remat=True, q_chunk=8, kv_chunk=8)
    assert loss.shape == () and np.isfinite(loss.item())
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_whisper_prefill_decode_smoke():
    """Mirrors tests/test_arch_smoke.py::test_prefill_decode_smoke[whisper-tiny]."""
    cfg = get_config(ARCH).reduced()
    api = registry.get(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    b, plen, max_len = 2, 16, 32
    state = api.init_state(cfg, b, max_len, torch.float32)
    inputs = registry.make_inputs(cfg, ShapeConfig("smoke", plen, b, "prefill"),
                                  torch.Generator().manual_seed(1))
    logits, state = api.prefill(params, inputs, state, cfg, q_chunk=8, kv_chunk=8)
    assert logits.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits2, state = api.decode_step(params, {"tokens": tok}, state, plen, cfg)
    assert logits2.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits2).all())


def test_whisper_full_config_dims_and_parameters():
    """whisper-tiny's full dims (tests/test_arch_smoke.py::test_exact_assigned_dims):
    56,371,200 parameters by the spec, the reference's count; 1,500 frames
    in its train inputs."""
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size) == \
        (4, 384, 6, 6, 1536, 51865)
    assert (c.n_encoder_layers, c.encoder_len, c.max_decode_len, c.head_dim) == (4, 1500, 448, 64)
    n = sum(int(np.prod(s.shape)) for _, s in common.tree_leaves(whisper.spec(c)))
    assert n == 56_371_200 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jwhisper.spec(jget_config(ARCH)), is_leaf=lambda x: isinstance(x, jcommon.ParamSpec)))
    assert registry.input_specs(c, SHAPES["train_4k"])["frames"] == ((256, 1500, 384),
                                                                     torch.bfloat16)


def test_whisper_clis_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: 2x4 tokens" in out and "step     2 loss" in out
    assert fa.LAUNCHES.count == before
