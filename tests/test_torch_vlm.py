"""The VLM family against the JAX reference on the CPU: internvl2-26b's
reduced config (4 layers, d_model 128, 4/2 heads of 32, 16 patch
positions, f32), the reference's weights carried across by
``registry.params_from_reference``.

The patches (the stubbed vision front end's embeddings, which replace the
first ``n_patches`` positions of the sequence) are made once with numpy
from a seed and handed to both packages: ``make_train_batch``'s stub
patches come from a ``torch.Generator`` in the port and from
``jax.random`` in the reference, so they differ by design.  Prompts are
longer than ``n_patches`` or exactly as long.

Held against the reference: prefill logits with patches and a decode step
after it, ``ServeEngine.generate``'s greedy tokens, ``loss_fn``'s value and
every gradient leaf, one AdamW step, the weight carry; against the port's
own teacher-forced forward: decode.  A prompt shorter than ``n_patches``
fails in both: with a shape error in the reference, with a ``ValueError``
naming both lengths in the port.

Tolerances are those ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py`` hold qwen3-4b and yi-6b to, f32 with sums in
another order: logits within 1e-4; the KV caches within 1e-4 of their
largest magnitude (entries of up to ~10, where the patches stand); decode
against teacher forcing within 2e-3; losses within 1e-5 relative; gradients within 1e-4 of each leaf's
largest magnitude, and the grad norm, which sums their squares, within 1e-4
relative; after one AdamW step the moments within 1e-3 of each leaf's max
and the parameters as ``test_vlm_train_step_equals_the_reference`` states.
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
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.models import common, registry, transformer
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "internvl2-26b"
N_PATCHES = 16  # the reduced config's
PROMPTS = [N_PATCHES + 8, N_PATCHES]  # longer than the patches, and exactly as long


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port model), the same weights."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jregistry.get(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, registry.params_from_reference(cfg, jax.tree.map(np.asarray,
                                                                                jparams))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _patches(cfg, batch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, cfg.n_patches, cfg.d_model),
                                                       dtype=np.float32)


def test_reduced_vlm_is_the_reference_family(carried):
    jcfg, _, cfg, model = carried
    assert cfg.family == jcfg.family == "vlm" and cfg.n_patches == N_PATCHES
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (4, 128, 4, 2, 32)
    assert registry.get(cfg) is registry._TRANSFORMER
    assert len(model["layers"]) == cfg.n_layers


@pytest.mark.parametrize("plen", PROMPTS)
def test_vlm_prefill_and_decode_logits_equal_the_reference(carried, plen):
    """Prefill of ``plen`` tokens whose first 16 positions the patches
    replace, then one decode step; the KV caches after both."""
    jcfg, jparams, cfg, model = carried
    toks = _tokens(cfg, (2, plen + 1), seed=plen)
    patches = _patches(cfg, 2, seed=100 + plen)
    jstate = jtransformer.init_state(jcfg, 2, plen + 4, jnp.float32)
    tstate = transformer.init_state(cfg, 2, plen + 4, torch.float32)
    jl, jstate = jtransformer.prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :plen]), "patches": jnp.asarray(patches)},
        jstate, jcfg, q_chunk=8, kv_chunk=8)
    tl, tstate = transformer.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :plen]), "patches": torch.from_numpy(patches)},
        tstate, cfg, q_chunk=8, kv_chunk=8)
    assert tl.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jl, jstate = jtransformer.decode_step(jparams, {"tokens": jnp.asarray(toks[:, plen:])},
                                          jstate, jnp.int32(plen), jcfg)
    tl, tstate = transformer.decode_step(model, {"tokens": torch.from_numpy(toks[:, plen:])},
                                         tstate, plen, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):  # each layer's cache, stacked as the reference's
        got = torch.stack([c[name] for c in tstate["dense"]]).numpy()
        assert _max_err(got, jstate["dense"][name]) <= 1e-4, name


def test_vlm_decode_matches_teacher_forcing(carried):
    """Prefill with patches, then 4 decode steps, against one cache-less
    forward over the same tokens and patches."""
    _, _, cfg, model = carried
    toks = torch.from_numpy(_tokens(cfg, (2, 24), seed=6))
    patches = torch.from_numpy(_patches(cfg, 2, seed=7))
    x, _, _ = transformer.forward(model, {"tokens": toks, "patches": patches}, cfg,
                                  q_chunk=8, kv_chunk=8)
    teacher = transformer._logits(model, x, cfg)[:, 19:]
    state = transformer.init_state(cfg, 2, 32, torch.float32)
    lg, state = transformer.prefill(model, {"tokens": toks[:, :20], "patches": patches}, state,
                                    cfg, q_chunk=8, kv_chunk=8)
    served = [lg]
    for t in range(20, 24):
        lg, state = transformer.decode_step(model, {"tokens": toks[:, t:t + 1]}, state, t, cfg)
        served.append(lg)
    np.testing.assert_allclose(torch.cat(served, 1)[:, :5].numpy(), teacher.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("plen", PROMPTS)
def test_vlm_serve_greedy_tokens_equal_the_reference(carried, plen):
    jcfg, jparams, cfg, model = carried
    prompts = _tokens(cfg, (2, plen), seed=8 + plen)
    patches = _patches(cfg, 2, seed=9 + plen)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=48)).generate(
        prompts, 6, extras={"patches": jnp.asarray(patches)})
    eng = ServeEngine(cfg, model, ServeConfig(max_len=48), device="cpu")
    got = eng.generate(prompts, 6, extras={"patches": patches})
    assert got.shape == (2, plen + 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6, extras={"patches": patches}), got)
    # the patches reach the logits: other patches, other tokens
    other = eng.generate(prompts, 6, extras={"patches": patches[::-1].copy()})
    assert not np.array_equal(other, got)


def test_short_prompt_with_patches_fails_in_both(carried):
    """A prompt of 12 tokens cannot hold 16 patch positions: the
    reference's generate fails with a shape error, the port's prefill and
    generate raise a ValueError naming both lengths."""
    jcfg, jparams, cfg, model = carried
    prompts = _tokens(cfg, (2, 12), seed=10)
    patches = _patches(cfg, 2, seed=11)
    with pytest.raises(TypeError, match="incompatible shapes"):
        JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(
            prompts, 4, extras={"patches": jnp.asarray(patches)})
    eng = ServeEngine(cfg, model, ServeConfig(max_len=32), device="cpu")
    with pytest.raises(ValueError, match="12 tokens is shorter than the 16 positions"):
        eng.generate(prompts, 4, extras={"patches": patches})
    with pytest.raises(ValueError, match="12 tokens is shorter than the 16 positions"):
        eng.prefill({"tokens": torch.from_numpy(prompts), "patches": torch.from_numpy(patches)},
                    eng.init_state(2))
    # without patches the same prompt serves
    assert eng.generate(prompts, 4).shape == (2, 16)


def _batch(cfg, step: int, seq: int = 24, batch: int = 4):
    """The reference pipeline's tokens and labels with numpy patches, for both."""
    raw = JTokenPipeline(JDataConfig(cfg.vocab_size, seq, batch, seed=0)).batch_at(step)
    patches = _patches(cfg, batch, seed=200 + step)
    tb = {k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    return (dict(tb, patches=torch.from_numpy(patches)),
            dict(jb, patches=jnp.asarray(patches)))


def test_vlm_loss_and_gradients_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch(cfg, 0)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=8, kv_chunk=8),
        has_aux=True))(jparams, jb)
    model = common.trainable(model)
    try:
        grads, metrics = train_step.make_grad_fn(cfg, q_chunk=8, kv_chunk=8)(model, tb)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jm) == {"nll", "aux", "loss"}
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    want = common.tree_leaves(jax.tree.map(np.asarray, jgrads))
    assert {p for p, _ in want} == set(got)
    for path, w in want:
        assert _max_err(got[path], w) <= 1e-4, common.path_name(path)


def test_vlm_train_step_equals_the_reference(carried):
    """One AdamW step: the loss, grad norm and lr are the reference's, and
    so are the moments and the updated parameters."""
    jcfg, jparams, cfg, _ = carried
    model = common.trainable(registry.params_from_reference(cfg, jax.tree.map(np.asarray,
                                                                              jparams)))
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(cfg, 1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=8,
                                                               kv_chunk=8))(
        jparams, jadamw.init(jparams, jopt), jb)
    model, state, m = train_step.make_train_step(cfg, opt, q_chunk=8, kv_chunk=8)(
        model, adamw.init(model, opt), tb)
    assert set(m) == set(jm) == {"loss", "nll", "aux", "grad_norm", "lr"}
    for key in jm:  # the grad norm sums the gradients' squares: their 1e-4
        tol = 1e-4 if key == "grad_norm" else 1e-5
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=tol, atol=1e-7,
                                   err_msg=key)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for k in ("m", "v"):  # the moments follow the gradients: 1e-3 of each leaf's max
        mine = dict(common.tree_leaves(registry.params_to_reference(cfg, state[k])))
        for path, w in common.tree_leaves(jax.tree.map(np.asarray, jstate[k])):
            assert _max_err(mine[path], w) <= 1e-3, (k, common.path_name(path))
    # Adam's first step moves a parameter by lr * g / (|g| + eps): by about
    # lr, signed as its gradient.  An element whose gradient lies within the
    # gradients' tolerance (1e-4 of the leaf's max) of 0 may take the other
    # sign, so every parameter is held within 2 lr of the reference's, and
    # those whose first moment exceeds 1e-3 of the leaf's max within 1e-5
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, model)))
    first = dict(common.tree_leaves(jax.tree.map(np.asarray, jstate["m"])))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jparams2)):
        off = np.abs(got[path] - w)
        clear = np.abs(first[path]) > 1e-3 * np.abs(first[path]).max()
        assert off.max() <= 2 * opt.peak_lr and off[clear].max() <= 1e-5, \
            common.path_name(path)


def test_vlm_weight_carry_covers_every_leaf(carried):
    jcfg, jparams, cfg, model = carried
    tree = jax.tree.map(np.asarray, jparams)
    leaves = jax.tree.leaves(jparams)
    n_layer_leaves = len(jax.tree.leaves(jparams["layers"]))
    assert len(list(model.parameters())) == \
        (len(leaves) - n_layer_leaves) + n_layer_leaves * cfg.n_layers
    assert common.count_params(model) == sum(int(x.size) for x in leaves)
    back = common.tree_leaves(registry.params_to_reference(cfg, model))
    want = common.tree_leaves(tree)
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=common.path_name(path))
    assert hasattr(model, "lm_head") == (not cfg.tie_embeddings)
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, dict(tree, stray=np.zeros(3, np.float32)))
