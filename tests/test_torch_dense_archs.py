"""yi-6b, minitron-8b and granite-34b against the JAX reference on the CPU,
on small configs that keep what sets each apart, made alike in both
packages with ``dataclasses.replace`` of their ``reduced()`` configs:

  * granite-34b keeping MQA at G = 48: 48 query heads of 16 on one kv head,
    2 layers (``reduced()`` has 4 heads: G = 4);
  * minitron-8b with a vocabulary of 4,096, so that its separate head (128
    x 4,096) is the largest leaf, level with the embedding, as its
    256,000-wide head is at full width (``reduced()``'s 512 hides it);
  * yi-6b's ``reduced()`` (4 layers, 4/2 heads of 32, a separate head).

Each is f32 and carries the reference's weights
(``registry.params_from_reference``); every input is made with numpy from
a seed and handed to both packages.  Held against the reference: the logits
of one cache-less forward over 13 tokens at ``q_chunk`` 5 and ``kv_chunk``
4 (chunks that split the sequence raggedly; at G = 48 a chunk of 5
positions holds 240 (position, query head) rows); a prefill of 11 tokens
and two decode steps, logits and every layer's KV cache; the greedy tokens
of ``ServeEngine.generate``; ``loss_fn`` and every gradient leaf against
``jax.value_and_grad``, the separate head included; one AdamW step; and
``registry.params_to_reference`` inverting the carry.

Tolerances, f32 with sums in another order (XLA's scans against torch's
chunked einsums, ~1e-7 relative per op; the reference's init rule gives
hidden states of thousands at 2 layers): logits and KV caches within 1e-4
of their largest magnitude; tokens equal; losses within 1e-5 relative and
the grad norm, which sums the gradients' squares, within 1e-4; every
gradient within 1e-3 of its leaf's largest magnitude (an element near zero
carries the rounding of the terms that cancelled in it); after one AdamW
step the moments within 1e-3 of each leaf's max and the parameters as
``test_train_step_equals_the_reference`` states; the carry bitwise.
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

# (id, arch, the fields replaced in its reduced() config, in both packages)
CONFIGS = [
    ("granite-34b G=48", "granite-34b", {"n_heads": 48, "n_kv_heads": 1, "d_head": 16,
                                         "n_layers": 2}),
    ("minitron-8b vocab 4096", "minitron-8b", {"vocab_size": 4096}),
    ("yi-6b", "yi-6b", {}),
]
TOL = 1e-4  # logits and caches, of their largest magnitude
GRAD_TOL = 1e-3  # each gradient, of its leaf's largest magnitude


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=CONFIGS, ids=[c[0] for c in CONFIGS])
def carried(request):
    """(reference cfg, reference params, port cfg, port model), the same weights."""
    _, arch, fields = request.param
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **fields)
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    jparams = jregistry.get(jcfg).init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, registry.params_from_reference(cfg, jax.tree.map(np.asarray,
                                                                                jparams))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _batch(cfg, step: int, seq: int = 16, batch: int = 4):
    """The reference pipeline's numpy tokens and labels, for both packages."""
    raw = JTokenPipeline(JDataConfig(cfg.vocab_size, seq, batch, seed=0)).batch_at(step)
    return ({k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in ("tokens", "labels")},
            {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")})


def test_configs_keep_what_sets_each_apart(carried):
    jcfg, jparams, cfg, model = carried
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not cfg.tie_embeddings and hasattr(model, "lm_head")
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    if cfg.name == "granite-34b":
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (48, 1, 16)
    if cfg.name == "minitron-8b":
        assert sizes["lm_head"] == sizes["embed"] == max(sizes.values())
    assert common.count_params(model) == sum(int(x.size) for x in jax.tree.leaves(jparams))


def test_logits_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    toks = _tokens(cfg, (2, 13), seed=1)
    kw = {"q_chunk": 5, "kv_chunk": 4}
    jx, _, _ = jtransformer.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg, **kw)
    x, _, _ = transformer.forward(model, {"tokens": torch.from_numpy(toks)}, cfg, **kw)
    got = transformer._logits(model, x, cfg)
    assert got.shape == (2, 13, cfg.vocab_size)
    assert _max_err(got.numpy(), jtransformer._logits(jparams, jx, jcfg)) <= TOL


def test_prefill_and_decode_equal_the_reference(carried):
    """A prefill of 11 tokens, then two decode steps: the logits of each
    and every layer's KV cache after the last."""
    jcfg, jparams, cfg, model = carried
    toks = _tokens(cfg, (2, 13), seed=2)
    jstate = jtransformer.init_state(jcfg, 2, 16, jnp.float32)
    tstate = transformer.init_state(cfg, 2, 16, torch.float32)
    jl, jstate = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11])}, jstate,
                                      jcfg, q_chunk=5, kv_chunk=4)
    tl, tstate = transformer.prefill(model, {"tokens": torch.from_numpy(toks[:, :11])}, tstate,
                                     cfg, q_chunk=5, kv_chunk=4)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert _max_err(tl.numpy(), jl) <= TOL
    for t in (11, 12):
        jl, jstate = jtransformer.decode_step(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                              jstate, jnp.int32(t), jcfg)
        tl, tstate = transformer.decode_step(model, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                             tstate, t, cfg)
        assert _max_err(tl.numpy(), jl) <= TOL, t
    for name in ("k", "v"):  # each layer's cache, stacked as the reference's
        got = torch.stack([c[name] for c in tstate["dense"]]).numpy()
        assert got.shape[-2:] == (cfg.n_kv_heads, cfg.head_dim)
        assert _max_err(got, jstate["dense"][name]) <= TOL, name


def test_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    prompts = _tokens(cfg, (2, 10), seed=3)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=24)).generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=24), device="cpu")
    got = eng.generate(prompts, 6)
    assert got.shape == (2, 16) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loss_and_gradients_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch(cfg, 0)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=5, kv_chunk=4),
        has_aux=True))(jparams, jb)
    model = common.trainable(model)
    try:
        grads, metrics = train_step.make_grad_fn(cfg, q_chunk=5, kv_chunk=4)(model, tb)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jm) == {"nll", "aux", "loss"}
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    want = common.tree_leaves(jax.tree.map(np.asarray, jgrads))
    assert {p for p, _ in want} == set(got) and ("lm_head",) in got
    for path, w in want:
        assert _max_err(got[path], w) <= GRAD_TOL, common.path_name(path)


def test_train_step_equals_the_reference(carried):
    """One AdamW step: the loss, grad norm and lr are the reference's, and
    so are the moments and the updated parameters."""
    jcfg, jparams, cfg, _ = carried
    model = common.trainable(registry.params_from_reference(cfg, jax.tree.map(np.asarray,
                                                                              jparams)))
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(cfg, 1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=5,
                                                               kv_chunk=4))(
        jparams, jadamw.init(jparams, jopt), jb)
    model, state, m = train_step.make_train_step(cfg, opt, q_chunk=5, kv_chunk=4)(
        model, adamw.init(model, opt), tb)
    assert set(m) == set(jm) == {"loss", "nll", "aux", "grad_norm", "lr"}
    for key in jm:
        tol = 1e-4 if key == "grad_norm" else 1e-5
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=tol, atol=1e-7,
                                   err_msg=key)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for k in ("m", "v"):  # the moments follow the gradients: 1e-3 of each leaf's max
        mine = dict(common.tree_leaves(registry.params_to_reference(cfg, state[k])))
        for path, w in common.tree_leaves(jax.tree.map(np.asarray, jstate[k])):
            assert _max_err(mine[path], w) <= GRAD_TOL, (k, common.path_name(path))
    # Adam's first step moves a parameter by about lr, signed as its
    # gradient; an element whose gradient lies within the gradients'
    # tolerance of 0 may take the other sign, so every parameter is held
    # within 2 lr of the reference's, and those whose first moment exceeds
    # GRAD_TOL of the leaf's max within 1e-5
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, model)))
    first = dict(common.tree_leaves(jax.tree.map(np.asarray, jstate["m"])))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jparams2)):
        off = np.abs(got[path] - w)
        clear = np.abs(first[path]) > GRAD_TOL * np.abs(first[path]).max()
        assert off.max() <= 2 * opt.peak_lr and off[clear].max() <= 1e-5, \
            common.path_name(path)


def test_params_to_reference_inverts_the_carry(carried):
    """The reference's tree through the port and back is the same tree,
    bitwise; the port's own weights through the reference's tree and back
    are the same weights."""
    _, jparams, cfg, model = carried
    want = common.tree_leaves(jax.tree.map(np.asarray, jparams))
    back = common.tree_leaves(registry.params_to_reference(cfg, model))
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=common.path_name(path))
    own = registry.get(cfg).init(torch.Generator().manual_seed(1), cfg)
    again = registry.params_from_reference(cfg, registry.params_to_reference(cfg, own))
    for (name, a), (_, b) in zip(own.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
