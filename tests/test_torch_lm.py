"""The port's LM serving path against the JAX reference on the CPU, with the
reference's weights carried across (``registry.params_from_reference``).

Configs: ``qwen3-4b.reduced()`` (qk-norm, decoupled head dim, tied
embeddings) and ``yi-6b.reduced()`` (plain GQA, separate head), both f32.
Every input is made with numpy from a seed and handed to both packages.
Tolerances: 1e-4 at f32 on logits and on attention outputs (summation
order only; the reference's init rule gives activations of tens); the
elementwise pieces to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, common, ffn, registry, transformer
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCHS = ["qwen3-4b", "yi-6b"]


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(arch, reference cfg, reference params, port cfg, port model)."""
    arch = request.param
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = jregistry.get(jcfg).init(jax.random.PRNGKey(0), jcfg)
    model = registry.params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    return arch, jcfg, jparams, cfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


# -- configs ---------------------------------------------------------------------


def test_configs_equal_the_reference_field_by_field():
    assert ALL_ARCHS == J_ALL_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in ALL_ARCHS:
        for mine, ref in ((get_config(arch), jget_config(arch)),
                          (get_config(arch).reduced(), jget_config(arch).reduced())):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            assert (mine.head_dim, mine.n_params(), mine.active_params()) == \
                (ref.head_dim, ref.n_params(), ref.active_params()), arch
        for shape in SHAPES.values():
            assert shape_applicable(get_config(arch), shape)[0] == \
                (shape.name != "long_500k" or get_config(arch).supports_long_context)
    with pytest.raises(KeyError):
        get_config("gpt-5")


# -- the modules' pieces ------------------------------------------------------------


def test_rmsnorm_and_rope_equal_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32), dtype=np.float32)
    w = rng.standard_normal(32, dtype=np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    got = common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    want = np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for theta in (1e4, 1e6):
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
        want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # rotate-half: position 0 is the identity, and the halves (not pairs) rotate
    got0 = common.apply_rope(torch.from_numpy(x), torch.zeros((2, 7), dtype=torch.int32), 1e4)
    np.testing.assert_array_equal(got0.numpy(), x)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = common.rmsnorm(xb, torch.from_numpy(w), 1e-6)
    want = jcommon.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_ffn_layernorm_and_loss_equal_the_reference():
    cfg = get_config("yi-6b").reduced()
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s.shape, dtype=np.float32) / 8
         for k, s in ffn.spec(cfg).items()}
    x = rng.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    got = ffn.apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    want = jffn.apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pg = {k: rng.standard_normal(s.shape, dtype=np.float32) / 8
          for k, s in ffn.spec_gelu(cfg).items()}
    got = ffn.apply_gelu({k: torch.from_numpy(v) for k, v in pg.items()}, torch.from_numpy(x))
    want = jffn.apply_gelu({k: jnp.asarray(v) for k, v in pg.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    w, b = rng.standard_normal(cfg.d_model, dtype=np.float32), rng.standard_normal(
        cfg.d_model, dtype=np.float32)
    got = common.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jcommon.layernorm(*(jnp.asarray(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = common.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           None if m is None else torch.from_numpy(m))
        want = jcommon.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                             None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_attention_apply_with_and_without_cache(carried):
    _, jcfg, jparams, cfg, model = carried
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = model["layers"][0]["attn"]
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    kw = {"q_chunk": 8, "kv_chunk": 8}
    got, cache = attention.apply(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos), **kw)
    want, _ = jattn.apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    oracle = attention.attention_ref(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # prefill 11 into a cache, then decode the 12th: the cache rows and the
    # output equal the reference's
    tcache = attention.init_cache(cfg, 2, 16, torch.float32)
    jcache = jattn.init_cache(jcfg, 2, 16, jnp.float32)
    _, tcache = attention.apply(tp, torch.from_numpy(x[:, :11]), cfg,
                                positions=torch.from_numpy(pos[:, :11]), cache=tcache,
                                cur_len=0, **kw)
    _, jcache = jattn.apply(jp, jnp.asarray(x[:, :11]), jcfg, positions=jnp.asarray(pos[:, :11]),
                            cache=jcache, cur_len=jnp.int32(0), **kw)
    got, tcache = attention.apply(tp, torch.from_numpy(x[:, 11:]), cfg,
                                  positions=torch.from_numpy(pos[:, 11:]), cache=tcache,
                                  cur_len=11)
    want, jcache = jattn.apply(jp, jnp.asarray(x[:, 11:]), jcfg, positions=jnp.asarray(pos[:, 11:]),
                               cache=jcache, cur_len=jnp.int32(11))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(oracle)[:, 11], rtol=1e-4, atol=1e-4)


def test_decode_attention_equals_the_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 8, 32), dtype=np.float32)
    kc, vc = (rng.standard_normal((2, 20, 2, 32), dtype=np.float32) for _ in range(2))
    got = attention.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)), 13)
    want = jattn.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)), jnp.int32(13))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the model ----------------------------------------------------------------------


def test_prefill_and_decode_logits_equal_the_reference(carried):
    _, jcfg, jparams, cfg, model = carried
    toks = _tokens(cfg, (2, 12), seed=5)
    jstate = jtransformer.init_state(jcfg, 2, 16, jnp.float32)
    tstate = transformer.init_state(cfg, 2, 16, torch.float32)
    jl, jstate = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11])}, jstate, jcfg,
                                      q_chunk=8, kv_chunk=8)
    tl, tstate = transformer.prefill(model, {"tokens": torch.from_numpy(toks[:, :11])}, tstate,
                                     cfg, q_chunk=8, kv_chunk=8)
    assert tl.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jl, _ = jtransformer.decode_step(jparams, {"tokens": jnp.asarray(toks[:, 11:])}, jstate,
                                     jnp.int32(11), jcfg)
    tl, _ = transformer.decode_step(model, {"tokens": torch.from_numpy(toks[:, 11:])}, tstate,
                                    11, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_decode_matches_teacher_forcing(carried):
    """Greedy decode logits == teacher-forcing forward logits (mirrors
    tests/test_arch_smoke.py::test_decode_matches_teacher_forcing)."""
    _, _, _, cfg, model = carried
    toks = torch.from_numpy(_tokens(cfg, (2, 12), seed=6))
    x, _, _ = transformer.forward(model, {"tokens": toks}, cfg, q_chunk=8, kv_chunk=8)
    full_logits = transformer._logits(model, x, cfg)
    state = transformer.init_state(cfg, 2, 16, torch.float32)
    _, state = transformer.prefill(model, {"tokens": toks[:, :11]}, state, cfg, q_chunk=8, kv_chunk=8)
    logits, _ = transformer.decode_step(model, {"tokens": toks[:, 11:12]}, state, 11, cfg)
    np.testing.assert_allclose(logits[:, 0].numpy(), full_logits[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_serve_greedy_tokens_equal_the_reference(carried):
    """Mirrors tests/test_train_serve_e2e.py::test_serve_greedy_deterministic,
    and holds the tokens to the reference engine's."""
    _, jcfg, jparams, cfg, model = carried
    prompts = np.concatenate([np.full((1, 8), 7, np.int32), _tokens(cfg, (1, 8), seed=7)])
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=48)).generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=48), device="cpu")
    a, b = eng.generate(prompts, 6), eng.generate(prompts, 6)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 14) and a.dtype == np.int32
    np.testing.assert_array_equal(a, want)
    same = eng.generate(np.full((2, 8), 7, np.int32), 6)
    np.testing.assert_array_equal(same[0], same[1])
    assert set(eng.last_timings) == {"prefill_s", "decode_s", "decode_steps"}


def test_serve_temperature_sampling_is_seeded(carried):
    _, _, _, cfg, model = carried
    prompts = _tokens(cfg, (2, 6), seed=8)
    runs = [ServeEngine(cfg, model, ServeConfig(max_len=32, temperature=1.0, seed=s),
                        device="cpu").generate(prompts, 10) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert np.all((runs[0] >= 0) & (runs[0] < cfg.vocab_size))
    np.testing.assert_array_equal(runs[0][:, :6], prompts)


def test_weight_carry_covers_every_leaf(carried):
    arch, jcfg, jparams, cfg, model = carried
    leaves = jax.tree.leaves(jparams)
    n_layer_leaves = len(jax.tree.leaves(jparams["layers"]))
    # every stacked leaf becomes n_layers parameters; every other leaf one
    assert len(list(model.parameters())) == \
        (len(leaves) - n_layer_leaves) + n_layer_leaves * cfg.n_layers
    assert common.count_params(model) == sum(int(x.size) for x in leaves)
    np.testing.assert_array_equal(model["layers"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["layers"]["attn"]["wq"][1]))
    tree = jax.tree.map(np.asarray, jparams)
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, extra)
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        registry.params_from_reference(cfg, short)
    assert hasattr(model, "lm_head") == (not cfg.tie_embeddings)


def test_init_follows_the_reference_rule():
    """Stacked leaves take fan_in = n_layers (shape[0]), embeddings 0.02,
    norms ones; the same seed gives the same weights."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), n_layers=16)
    model = transformer.init(torch.Generator().manual_seed(0), cfg)
    again = transformer.init(torch.Generator().manual_seed(0), cfg)
    wq = torch.stack([lp["attn"]["wq"] for lp in model["layers"]])
    assert abs(wq.std().item() - 1 / 4) < 0.01  # 1/sqrt(16), not 1/sqrt(d_model)
    assert abs(model["embed"].std().item() - 0.02) < 0.002
    assert torch.equal(model["layers"][3]["attn"]["q_norm"], torch.ones(cfg.head_dim))
    assert torch.equal(model["layers"][5]["ffn"]["w_up"], again["layers"][5]["ffn"]["w_up"])
    spec_shapes = {p: s.shape for p, s in common.tree_leaves(transformer.spec(cfg))}
    jspec = {p: s.shape for p, s in common.tree_leaves(jtransformer.spec(jget_config("qwen3-4b").reduced()))}
    assert {p: s[1:] for p, s in spec_shapes.items() if p[0] == "layers"} == \
        {p: s[1:] for p, s in jspec.items() if p[0] == "layers"}


def test_unported_families_raise_naming_their_item():
    for arch in ("whisper-tiny", "zamba2-1.2b", "xlstm-125m"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            registry.get(get_config(arch).reduced())
    cfg = get_config("deepseek-v3-671b").reduced()
    with pytest.raises(NotImplementedError, match="MLA"):
        registry.get(cfg).spec(cfg)
    with pytest.raises(NotImplementedError, match="MLA"):  # the loss waits for it too
        registry.get(cfg).loss_fn(None, {}, cfg)


def test_inputs_match_their_specs():
    cfg = get_config("internvl2-26b").reduced()
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=24, global_batch=2)
    specs = registry.input_specs(cfg, shape)
    jspecs = jregistry.input_specs(jget_config("internvl2-26b").reduced(), J_SHAPES["prefill_32k"])
    assert set(specs) == set(jspecs) == {"tokens", "patches"}
    inputs = registry.make_inputs(cfg, shape, torch.Generator().manual_seed(0))
    for name, (shp, dtype) in specs.items():
        assert tuple(inputs[name].shape) == shp and inputs[name].dtype == dtype
    assert int(inputs["tokens"].max()) < cfg.vocab_size
    # the VLM stub: patch embeddings replace the first n_patches positions
    model = transformer.init(torch.Generator().manual_seed(1), cfg)
    x = transformer._embed_inputs(model, inputs, cfg)
    assert torch.equal(x[:, :cfg.n_patches], inputs["patches"])


def test_engine_needs_cuda_unless_told_cpu(monkeypatch):
    cfg = get_config("yi-6b").reduced()
    model = transformer.init(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, model, ServeConfig(max_len=16))
    with pytest.raises(ValueError, match="exceed max_len"):
        ServeEngine(cfg, model, ServeConfig(max_len=16), device="cpu").generate(
            np.zeros((1, 10), np.int32), 8)


def test_serve_cli_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", "qwen3-4b", "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    assert "qwen3-4b: 2x4 tokens" in capsys.readouterr().out
    assert fa.LAUNCHES.count == before
