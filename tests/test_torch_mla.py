"""The port's MLA (multi-head latent attention) against the JAX reference on
the CPU: the layer (the decompressed flash path and the absorbed decode),
the flash plain version at a value head narrower than the key head, and
deepseek-v3's reduced model (MLA in every layer, a leading dense layer,
sigmoid aux-free routing, a shared expert, the MTP head): prefill logits,
the filled latent cache, decode logits, greedy tokens, the loss with its
gradients, and the weight carry.

Every input is made with numpy from a seed; the layer's weights are the
reference's ``init_params``, the model's the reference's tree with numpy
weights (``_tree``), carried by ``registry.params_from_reference``.

Tolerances, f32: sums in another order (XLA's against torch's, one matmul
over the flattened heads against an einsum), ~1e-7 relative per op: a
layer's output within 1e-5; logits and losses within 1e-4; gradients within
1e-3 of each leaf's largest magnitude (an element near zero carries the
rounding of the terms that cancelled in it), as ``test_torch_moe.py``
holds them.  The absorbed decode against the decompressed oracle is
another algorithm (scores against the latents, not against decompressed
keys): 1e-4, the reference's own tolerance for that pair
(``tests/test_attention_and_mla.py``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.kernels import ref as jkref
from repro.models import common as jcommon
from repro.models import mla as jmla
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common, mla, registry, transformer
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v3-671b"
SEQ, BATCH = 16, 2


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the MLA layer ------------------------------------------------------------------------


def _mla_cfgs():
    """The reference's MLA test config (tests/test_attention_and_mla.py:_mla_cfg)
    in both packages: qk head 16 + 8, v head 16."""
    base = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=128, vocab_size=97, dtype="float32", use_mla=True, q_lora_rank=48,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, reference params, port cfg, port params, x, positions)."""
    jcfg, cfg = _mla_cfgs()
    jp = jcommon.init_params(jmla.spec(jcfg), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(1).standard_normal((2, 16, 64), dtype=np.float32)
    pos = np.tile(np.arange(16), (2, 1))
    return jcfg, jp, cfg, params, x, pos


def test_mla_spec_is_the_reference_spec(layer):
    jcfg, _, cfg, _, _, _ = layer
    want = {p: s.shape for p, s in common.tree_leaves(jmla.spec(jcfg))}
    assert {p: s.shape for p, s in common.tree_leaves(mla.spec(cfg))} == want
    cache = mla.init_cache(cfg, 2, 24, torch.float32)
    jcache = jmla.init_cache(jcfg, 2, 24, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    assert {k: s for k, (s, _) in mla.cache_spec(cfg, 2, 24).items()} == \
        {k: v.shape for k, v in jmla.cache_spec(jcfg, 2, 24).items()}


@pytest.mark.parametrize("chunks", [(8, 8), (16, 4), (6, 10)], ids=["8x8", "16x4", "ragged"])
def test_mla_prefill_equals_the_reference(layer, chunks):
    """The decompressed flash path (no cache) against the reference's, and
    against the port's full-materialization oracle."""
    jcfg, jp, cfg, params, x, pos = layer
    q_chunk, kv_chunk = chunks
    want, _ = jmla.apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                         q_chunk=q_chunk, kv_chunk=kv_chunk)
    got, cache = mla.apply(params, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                           q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert cache is None and got.shape == (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    oracle = mla.mla_ref(params, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5, atol=1e-5)


def test_mla_absorbed_decode_equals_the_reference(layer):
    """Token by token through the latent cache: each step against the
    reference's absorbed decode (and its cache against the reference's),
    and the whole against the decompressed oracle ``mla_ref``."""
    jcfg, jp, cfg, params, x, pos = layer
    jcache = jmla.init_cache(jcfg, 2, 16, jnp.float32)
    cache = mla.init_cache(cfg, 2, 16, torch.float32)
    outs = []
    for t in range(16):
        jo, jcache = jmla.apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                positions=jnp.asarray(pos[:, t:t + 1]), cache=jcache,
                                cur_len=jnp.int32(t))
        o, cache = mla.apply(params, torch.from_numpy(x[:, t:t + 1]), cfg,
                             positions=torch.from_numpy(pos[:, t:t + 1]), cache=cache, cur_len=t)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        outs.append(o)
    for name in ("ckv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)
    oracle = mla.mla_ref(params, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), oracle.numpy(), rtol=1e-4, atol=1e-4)


def test_mla_prefill_into_a_cache_writes_the_latents(layer):
    """A prompt given a cache: the same output as without one, and its
    latents in the cache's first rows, those of ``_kv_latent``."""
    _, _, cfg, params, x, pos = layer
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    cache = mla.init_cache(cfg, 2, 20, torch.float32)
    got, cache = mla.apply(params, tx, cfg, positions=tpos, cache=cache, cur_len=0,
                           q_chunk=8, kv_chunk=8)
    want, _ = mla.apply(params, tx, cfg, positions=tpos, q_chunk=8, kv_chunk=8)
    assert torch.equal(got, want)
    c, k_rope = mla._kv_latent(params, tx, cfg, tpos)
    assert torch.equal(cache["ckv"][:, :16], c) and torch.equal(cache["k_rope"][:, :16], k_rope)
    assert not cache["ckv"][:, 16:].any() and not cache["k_rope"][:, 16:].any()
    with pytest.raises(ValueError, match="needs cur_len"):
        mla.apply(params, tx[:, :1], cfg, positions=tpos[:, :1], cache=cache)


def test_mla_hands_the_flash_entry_its_parts(layer, monkeypatch):
    """Prefill and training call ``flash_attention_split`` on the parts as
    MLA makes them: q_nope a view of the q projection (its rope columns
    follow in memory), q_rope, k_nope and v per head, and k_rope's one
    channel for every head, with no concatenation of q or k.  The output
    and every gradient equal the oracle's concatenated path."""
    _, _, cfg, params, x, pos = layer
    seen = []
    entry = fa.flash_attention_split

    def spy(*parts, **kw):
        seen.append([(tuple(t.shape), t.is_contiguous()) for t in parts])
        return entry(*parts, **kw)

    monkeypatch.setattr(fa, "flash_attention_split", spy)
    leaves = {name: t.clone().requires_grad_() for name, t in params.items()}
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    got, _ = mla.apply(leaves, tx, cfg, positions=tpos, q_chunk=8, kv_chunk=8)
    nope, rope, vd, h = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.n_heads
    assert seen == [[((2, 16, h, nope), False), ((2, 16, h, rope), True),
                     ((2, 16, h, nope), True), ((2, 16, 1, rope), True),
                     ((2, 16, h, vd), True)]]
    ref = {name: t.clone().requires_grad_() for name, t in params.items()}
    want = mla.mla_ref(ref, tx, cfg, tpos)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5)
    cot = torch.from_numpy(np.random.default_rng(2).standard_normal(tuple(got.shape),
                                                                    dtype=np.float32))
    got.backward(cot)
    want.backward(cot)
    for name in leaves:
        assert _max_err(leaves[name].grad, ref[name].grad) < 1e-4, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(8, 8), (5, 7)], ids=["8x8", "ragged"])
def test_flash_plain_with_a_narrower_value_head(causal, chunks):
    """``flash_attention_plain`` at (D, Dv) = (24, 16), GQA G = 2, against
    the reference's full-materialization oracle."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 24, 4, 24), dtype=np.float32)
    k = rng.standard_normal((2, 24, 2, 24), dtype=np.float32)
    v = rng.standard_normal((2, 24, 2, 16), dtype=np.float32)
    want = jkref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1])
    assert got.shape == (2, 24, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_heads_are_the_kernels_mla_pair():
    """``with_kernel_heads`` gives the head dims of deepseek-v3 itself, which
    is the flash kernel's one pair with Dv != D."""
    full, cut = get_config(ARCH), mla.with_kernel_heads(get_config(ARCH).reduced())
    for name in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim"):
        assert getattr(cut, name) == getattr(full, name)
    assert (cut.qk_nope_head_dim + cut.qk_rope_head_dim, cut.v_head_dim) in fa.HEAD_DIMS
    assert [p for p in fa.HEAD_DIMS if p[0] != p[1]] == [(192, 128)]
    assert cut.d_model == get_config(ARCH).reduced().d_model


# -- deepseek-v3 reduced -------------------------------------------------------------------


def _tree(cfg, seed: int) -> dict:
    """The reference's tree with numpy weights: zeros, ones, or
    ``scale * N(0, 1)`` with the spec's scale, else 0.05 (activations O(1);
    see ``test_torch_moe.py``'s ``_tree``)."""
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(transformer.spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = (rng.standard_normal(s.shape) * (s.scale or 0.05)).astype(np.float32)
        common.tree_set(tree, path, x)
    return tree


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port model, the tree):
    deepseek-v3 reduced, the same weights on both sides."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _tree(cfg, seed=0)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            registry.params_from_reference(cfg, tree), tree)


def test_deepseek_reduced_is_mla_dense_and_moe(carried):
    jcfg, jparams, cfg, model, tree = carried
    assert cfg.use_mla and cfg.router_aux_free and cfg.n_shared_experts and cfg.mtp_depth
    assert set(tree) == set(jtransformer.spec(jcfg)) >= {"layers", "moe_layers", "mtp"}
    assert len(model["layers"]) == cfg.n_dense_layers == 1
    assert len(model["moe_layers"]) == cfg.n_layers - 1
    assert set(tree["layers"]["attn"]) == set(mla.spec(cfg))


def test_mla_weight_carry_round_trips(carried):
    """Every MLA leaf (w_dq, q_norm, w_uq, w_dc, w_dr, kv_norm, w_uk, w_uv,
    wo) is carried both ways, in both stacks and the MTP layer."""
    jcfg, jparams, cfg, model, tree = carried
    assert [p for p, _ in common.tree_leaves(tree)] == \
        [p for p, _ in common.tree_leaves(jregistry.get(jcfg).spec(jcfg))]
    assert common.count_params(model) == sum(int(x.size) for x in jax.tree.leaves(jparams))
    back = registry.params_to_reference(cfg, model)
    got, want = common.tree_leaves(back), common.tree_leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
    carried_mla = {p[-1] for p, _ in got if p[-2:-1] == ("attn",)}
    assert carried_mla == set(mla.spec(cfg))
    named = dict(model.named_parameters())
    del named["moe_layers.0.attn.w_uk"]
    with pytest.raises(ValueError, match="no leaf named moe_layers.0.attn.w_uk"):
        registry.params_to_reference(cfg, named)


def test_deepseek_prefill_cache_and_decode_equal_the_reference(carried):
    """Prefill logits; the latent cache the prefill fills, layer by layer,
    against the reference's ``_mla_prefill_cache``; one decode step's
    logits and the cache row it writes."""
    jcfg, jparams, cfg, model, _ = carried
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jstate = jtransformer.init_state(jcfg, 2, 16, jnp.float32)
    state = transformer.init_state(cfg, 2, 16, torch.float32)
    assert set(state) == set(jstate) == {"dense", "moe"}
    jl, jstate = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11])}, jstate, jcfg,
                                      q_chunk=8, kv_chunk=8)
    tl, state = transformer.prefill(model, {"tokens": torch.from_numpy(toks[:, :11])}, state,
                                    cfg, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)

    def same_caches():
        for key in ("dense", "moe"):
            for i, cache in enumerate(state[key]):
                for name in ("ckv", "k_rope"):
                    np.testing.assert_allclose(cache[name].numpy(), np.asarray(jstate[key][name][i]),
                                               rtol=1e-5, atol=1e-5, err_msg=f"{key}/{i}/{name}")

    same_caches()
    assert not state["moe"][0]["ckv"][:, 11:].any()
    jl, jstate = jtransformer.decode_step(jparams, {"tokens": jnp.asarray(toks[:, 11:])}, jstate,
                                          jnp.int32(11), jcfg)
    tl, state = transformer.decode_step(model, {"tokens": torch.from_numpy(toks[:, 11:])}, state,
                                        11, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    same_caches()


def test_deepseek_serve_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model, _ = carried
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(prompts, 6)
    eng = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=32), device="cpu")
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), got)


def test_deepseek_loss_and_gradients_equal_the_reference(carried):
    """loss_fn with the MTP head (labels2): nll, aux (0: aux-free routing),
    mtp_nll and the total, and every leaf's gradient, through the flash
    plain backward at (D, Dv) = (48, 32)."""
    jcfg, jparams, cfg, model, _ = carried
    raw = JTokenPipeline(JDataConfig(cfg.vocab_size, SEQ, BATCH, seed=0)).batch_at(0)
    keys = ("tokens", "labels", "labels2")
    tb = {k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in keys}
    jb = {k: jnp.asarray(raw[k]) for k in keys}
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=8, kv_chunk=8),
        has_aux=True))(jparams, jb)
    model = common.trainable(copy.deepcopy(model))
    grads, metrics = train_step.make_grad_fn(cfg, q_chunk=8, kv_chunk=8)(model, tb)
    assert set(metrics) == set(jm) == {"nll", "aux", "mtp_nll", "loss"}
    assert float(jm["aux"]) == 0.0
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-4, atol=1e-4)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jgrads)):
        if path[-1] == "router_bias":  # read detached: a zero gradient in both
            assert not np.any(w) and not np.any(got[path])
            continue
        assert _max_err(got[path], w) <= 1e-3, "/".join(path)
    assert np.any(got[("mtp", "layer", "attn", "w_uk")])  # the MTP layer is an MLA layer


def test_deepseek_serve_cli_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    assert f"{ARCH}: 2x4 tokens" in capsys.readouterr().out
    assert fa.LAUNCHES.count == before
