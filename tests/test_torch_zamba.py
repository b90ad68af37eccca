"""The port's Zamba2 hybrid against the JAX reference on the CPU: the
Mamba2 mixer (the chunked SSD, the causal conv, decode and prefill with a
state), and zamba2-1.2b's reduced model (5 Mamba2 layers, the one shared
attention block after every 2: 2 applications and a tail layer): the
loss and every gradient (the shared block's summed over its
applications), prefill and decode logits with the state trees, greedy
serving, a train step with AdamW, the weight carry, remat, training
resumed bitwise, and both CLIs.

Every input is made with numpy from a seed; the mixer's weights are the
reference's ``init_params``, the model's a numpy tree (``_tree``), carried
by ``registry.params_from_reference``.

Tolerances, f32: sums in another order (XLA's against torch's, the SSD's
products contracted in another order), ~1e-7 relative per op: the mixer,
the SSD output and the state within 1e-5 of each output's max; logits
within 1e-4; losses within 1e-5 relative; gradients within 1e-3 of each
leaf's largest magnitude (an element near zero carries the rounding of
the terms that cancelled in it); after one AdamW step the moments as the
gradients, the parameters as ``test_zamba_train_step_equals_the_reference``
states.  bf16 (the mixer): each op rounds to bf16
(2^-9 relative) in both, in other places (``F.silu`` rounds once where
``jax.nn.silu`` rounds twice), some 16 times along the mixer's longest
chain: within 2^-5 of the output's max (see
``test_mamba2_apply_equals_the_reference``).  That bound cannot see the
mixer's f32 stage (dt, A, the SSD, the skip term, the state), so a bf16
mixer's stage is held at the f32 tolerance against a float64 oracle on
its own inputs (``test_mamba2_bf16_keeps_the_f32_stage``).  The
chunked SSD against its own sequential oracle: rtol 1e-3, atol 1e-4, the
reference's own test's tolerance.
"""
import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import common as jcommon
from repro.models import mamba2 as jmamba2
from repro.models import registry as jregistry
from repro.models import zamba as jzamba
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, mamba2, registry, zamba
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import loop, train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "zamba2-1.2b"
SEQ, BATCH = 16, 2


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# -- the SSD and the Mamba2 mixer --------------------------------------------------------


def _hybrid_cfgs():
    """The reference's mixer test config (tests/test_ssm_and_moe.py:_hybrid_cfg)
    in both packages."""
    base = dict(name="h", family="hybrid", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=128, vocab_size=97, dtype="float32", ssm_state=16, ssm_heads=4,
                ssm_expand=2)
    return JModelConfig(**base), ModelConfig(**base)


def _ssd_inputs(seed: int, b: int = 2, s: int = 16, h: int = 2, p: int = 4, n: int = 8):
    """(x, dt, a, B, C) as numpy f32: dt post-softplus, a negative."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return (normal(b, s, h, p), np.log1p(np.exp(normal(b, s, h))).astype(np.float32),
            -np.exp(normal(h)), normal(b, s, n), normal(b, s, n))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@hypothesis.settings(deadline=None, max_examples=10)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), chunk=st.sampled_from([4, 8, 16]))
def test_ssd_chunked_vs_sequential(seed, chunk):
    """Mirrors tests/test_ssm_and_moe.py::test_ssd_chunked_vs_sequential."""
    x, dt, a, b_in, c_in = _t(*_ssd_inputs(seed))
    y, hf = mamba2.ssd_chunked(x, dt, a, b_in, c_in, chunk=chunk)
    y_ref, hf_ref = mamba2.ssd_ref(x, dt, a, b_in, c_in)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), hf_ref.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-state", "h0"])
def test_ssd_chunked_equals_the_reference(chunk, with_h0):
    arrays = _ssd_inputs(3)
    h0 = np.random.default_rng(4).standard_normal((2, 2, 4, 8)).astype(np.float32)
    kw = {"h0": h0} if with_h0 else {}
    jy, jh = jmamba2.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    y, hf = mamba2.ssd_chunked(*_t(*arrays), chunk=chunk,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert _max_err(y.numpy(), jy) <= 1e-5 and _max_err(hf.numpy(), jh) <= 1e-5


def test_ssd_chunked_raises_where_the_reference_asserts():
    """A length that is no multiple of the chunk: the reference asserts, the
    port raises ValueError on the same inputs; a length under the chunk is
    one chunk in both."""
    arrays = _ssd_inputs(5, s=12)
    with pytest.raises(AssertionError):
        jmamba2.ssd_chunked(*map(jnp.asarray, arrays), chunk=8)
    with pytest.raises(ValueError, match="not a multiple of chunk 8"):
        mamba2.ssd_chunked(*_t(*arrays), chunk=8)
    jy, _ = jmamba2.ssd_chunked(*map(jnp.asarray, arrays), chunk=128)
    y, _ = mamba2.ssd_chunked(*_t(*arrays), chunk=128)
    assert _max_err(y.numpy(), jy) <= 1e-5


def test_segsum_masks_before_exp_so_gradients_stay_finite():
    """Large decays: exp of the upper triangle's differences would overflow,
    so the mask goes in before exp, and the gradient is finite."""
    da = torch.tensor([[-30.0, -40.0, -50.0, -60.0, -70.0, -80.0, -90.0, -100.0]],
                      requires_grad=True)
    l_mat = torch.exp(mamba2._segsum(da))
    assert torch.equal(l_mat.detach().triu(1), torch.zeros(1, 8, 8))
    (g,) = torch.autograd.grad(l_mat.sum(), da)
    assert bool(torch.isfinite(g).all())
    j = np.asarray(jnp.exp(jmamba2._segsum(jnp.asarray(da.detach().numpy()))))
    # XLA flushes subnormals to zero (exp(-60) .. in f32), torch keeps them
    np.testing.assert_allclose(l_mat.detach().numpy(), j, rtol=1e-6, atol=1e-37)


def _mixer(seed: int = 5):
    jcfg, cfg = _hybrid_cfgs()
    jp = jcommon.init_params(jmamba2.spec(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_mamba2_prefill_decode_parity():
    """Mirrors tests/test_ssm_and_moe.py::test_mamba2_prefill_decode_parity."""
    _, cfg, _, params = _mixer()
    x = torch.from_numpy(_x((2, 16, 64), 6))
    y_full, _ = mamba2.apply(params, x, cfg, chunk=8)
    st_ = mamba2.init_state(cfg, 2)
    outs = []
    for t in range(16):
        o, st_ = mamba2.apply(params, x[:, t:t + 1], cfg, state=st_)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(), rtol=1e-3, atol=1e-4)


def test_mamba2_chunked_prefill_with_state():
    """Mirrors tests/test_ssm_and_moe.py::test_mamba2_chunked_prefill_with_state:
    prefill in two halves with carried state == one-shot prefill."""
    _, cfg, _, params = _mixer()
    x = torch.from_numpy(_x((2, 16, 64), 6))
    y_full, _ = mamba2.apply(params, x, cfg, chunk=8)
    st_ = mamba2.init_state(cfg, 2)
    y1, st_ = mamba2.apply(params, x[:, :8], cfg, state=st_, chunk=4)
    y2, st_ = mamba2.apply(params, x[:, 8:], cfg, state=st_, chunk=4)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["no-state", "decode", "prefill-with-state"])
def test_mamba2_apply_equals_the_reference(mode, dtype):
    """The mixer's output and new state against the reference's, from a
    nonzero state (its first 8 tokens' prefill) where there is one.  f32:
    within 1e-5 of the max.  bf16: within 2^-5 of the max.  The mixer's
    longest chain rounds to bf16 some 16 times at the output's scale (the
    input projection, the four conv products and three sums, the bias, the
    silu, the cast and the gate, the norm's three, the output projection),
    each within 2^-9 of the value, in other places in the two packages
    (XLA may keep a fused chain in f32): 16 x 2^-9 = 2^-5.  Here the
    reference's own bf16 output lies 2.0e-2 of the max from its f32 output,
    the port's 1.1e-2, and the two differ by 1.5e-2."""
    jcfg, cfg, jp, params = _mixer(seed=7)
    x = _x((2, 24, 64), 8)
    rest = {"no-state": None, "decode": slice(8, 9), "prefill-with-state": slice(8, 24)}[mode]

    def run(apply, p, c, xs, init_state):
        """(out, state or None): the whole input without a state, or its
        first 8 tokens' prefill and then ``rest`` from that state."""
        if rest is None:
            return apply(p, xs, c, chunk=8)
        _, st_ = apply(p, xs[:, :8], c, state=init_state(c, 2), chunk=8)
        return apply(p, xs[:, rest], c, state=st_, chunk=8)

    jy, jst = run(jmamba2.apply, jp, jcfg, jnp.asarray(x).astype(getattr(jnp, dtype)),
                  jmamba2.init_state)
    y, tst = run(mamba2.apply, params, cfg, torch.from_numpy(x).to(getattr(torch, dtype)),
                 mamba2.init_state)
    assert y.dtype == getattr(torch, dtype) and (tst is None) == (rest is None)
    found = {"out": (_np(y), jy)}
    if tst is not None:
        assert tst["ssm"].dtype == tst["conv"].dtype == torch.float32
        found.update({name: (_np(tst[name]), jst[name]) for name in ("ssm", "conv")})
    for name, (got, want) in found.items():
        assert got.shape == want.shape, name
        tol = 1e-5 if dtype == "float32" else 2.0**-5
        assert _max_err(got, np.asarray(want, np.float32)) <= tol, name


def _ssm_oracle(params, xs, dt_raw, b_in, c_in, hprev):
    """The mixer's f32 stage in float64, token by token (the recurrence that
    defines the SSD), as the reference's ``mamba2.apply`` states it: y with
    the skip term, and the final state."""
    x, b, c = (t.detach().double().numpy() for t in (xs, b_in, c_in))
    dt = np.logaddexp(0.0, dt_raw.double().numpy() + params["dt_bias"].double().numpy())
    a = -np.exp(params["a_log"].double().numpy())
    bsz, s, h, p = x.shape
    hst = np.zeros((bsz, h, p, b.shape[-1])) if hprev is None else hprev.double().numpy()
    ys = []
    for t in range(s):
        hst = hst * np.exp(dt[:, t] * a)[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], b[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", c[:, t], hst))
    return np.stack(ys, axis=1) + x * params["d_skip"].double().numpy()[None, None, :, None], hst


@pytest.mark.parametrize("mode", ["no-state", "decode", "prefill-with-state"])
def test_mamba2_bf16_keeps_the_f32_stage(mode, monkeypatch):
    """A bf16 mixer keeps the reference's f32 stage (its ``mamba2.apply``
    casts dt, A, the SSD's operands, the state and the skip term to f32):
    the stage's inputs (``mamba2._ssm``'s) as the bf16 mixer gives them are
    bf16 projections and an f32 state; its output and new state are f32
    and within 1e-5 of each one's max of a float64 oracle on the same
    inputs (the f32 tolerance).  The bf16 bound on the mixer's output
    (2^-5) cannot see this stage: one rounding to bf16 there is 2^-9 of a
    value, below the rest of the chain's.  Here it is ~100x above 1e-5."""
    _, cfg, _, params = _mixer(seed=7)
    x = torch.from_numpy(_x((2, 24, 64), 8)).to(torch.bfloat16)
    stage, seen = mamba2._ssm, []

    def spy(*args):
        out = stage(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(mamba2, "_ssm", spy)
    if mode == "no-state":
        mamba2.apply(params, x, cfg, chunk=8)
    else:
        _, st_ = mamba2.apply(params, x[:, :8], cfg, state=mamba2.init_state(cfg, 2), chunk=8)
        mamba2.apply(params, x[:, 8:9] if mode == "decode" else x[:, 8:], cfg, state=st_,
                     chunk=8)
    (p, xs, dt_raw, b_in, c_in, hprev, _), (y, hnew) = seen[-1]
    assert xs.dtype == dt_raw.dtype == b_in.dtype == c_in.dtype == torch.bfloat16
    assert (hprev is None) == (hnew is None) == (mode == "no-state")
    want_y, want_h = _ssm_oracle(p, xs, dt_raw, b_in, c_in, hprev)
    assert y.dtype == torch.float32 and _max_err(_np(y), want_y) <= 1e-5
    if hnew is not None:
        assert hprev.dtype == hnew.dtype == torch.float32
        assert _max_err(_np(hnew), want_h) <= 1e-5


def test_mamba2_spec_and_state_are_the_reference():
    jcfg, cfg = _hybrid_cfgs()
    assert mamba2.dims(cfg) == jmamba2.dims(jcfg)
    assert {p: s.shape for p, s in common.tree_leaves(mamba2.spec(cfg))} == \
        {p: s.shape for p, s in common.tree_leaves(jmamba2.spec(jcfg))}
    assert {k: tuple(v.shape) for k, v in mamba2.init_state(cfg, 3).items()} == \
        {k: v.shape for k, v in jmamba2.init_state(jcfg, 3).items()}


# -- zamba2-1.2b reduced ------------------------------------------------------------------


def _tree(cfg, seed: int) -> dict:
    """The reference's tree with numpy weights: zeros, ones, or
    ``scale * N(0, 1)`` with the spec's scale, else 0.05, as
    ``test_torch_moe.py`` draws them.  (The reference's init takes
    1/sqrt(shape[0]), the layer count for a stacked leaf: std 0.45 at 5
    layers, in-projections of ~7 and a loss of ~31 from a vocab of 512,
    which amplify f32 rounding layer by layer.  At 0.05 activations stay
    O(1).)"""
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(zamba.spec(cfg)):
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


def _batch(step: int = 0, seq: int = SEQ, batch: int = BATCH):
    raw = JTokenPipeline(JDataConfig(512, seq, batch, seed=0)).batch_at(step)
    return ({k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in ("tokens", "labels")},
            {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")})


def test_registry_returns_zamba_and_the_reduced_shape(carried):
    _, _, cfg, model = carried
    api = registry.get(cfg)
    assert api.loss_fn is zamba.loss_fn and api.from_tree is zamba.from_tree
    assert zamba._counts(cfg) == jzamba._counts(jget_config(ARCH).reduced()) == (2, 2, 1)
    assert len(model["mamba_layers"]) == cfg.n_layers == 5
    full = get_config(ARCH)
    assert zamba._counts(full) == (6, 6, 2)
    assert sum(int(np.prod(s.shape)) for _, s in common.tree_leaves(zamba.spec(full))) == \
        sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            jzamba.spec(jget_config(ARCH)), is_leaf=lambda x: isinstance(x, jcommon.ParamSpec)))


def test_zamba_tree_and_weight_carry(carried):
    """Every leaf is carried (stacked ``mamba_layers``, one ``shared_attn``)
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
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
    named = dict(model.named_parameters())
    del named["mamba_layers.3.mixer.a_log"]
    with pytest.raises(ValueError, match="no leaf named mamba_layers.3.mixer.a_log"):
        registry.params_to_reference(cfg, named)
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, dict(tree, stray=np.zeros(3, np.float32)))


@pytest.mark.parametrize("seq", [SEQ, 256], ids=["one-chunk", "two-chunks"])
def test_zamba_loss_and_gradients_equal_the_reference(carried, seq):
    """Every gradient, the shared block's (summed over its 2 applications)
    included; 256 tokens run the SSD in two chunks of 128."""
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch(seq=seq)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=8, kv_chunk=8),
        has_aux=True))(jparams, jb)
    model = common.trainable(model)
    try:
        grads, metrics = train_step.make_grad_fn(cfg, q_chunk=8, kv_chunk=8)(model, tb)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jm) == {"nll", "loss"}
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jgrads)):
        assert _max_err(got[path], w) <= 1e-3, "/".join(path)
    assert np.any(got[("shared_attn", "attn", "wq")])


def test_shared_block_gradient_sums_its_applications(carried):
    """The shared block's gradient is the sum of what each application
    gives: two copies of the block, one per application, get gradients that
    add up to the shared one's."""
    _, _, cfg, model = carried
    tb, _ = _batch()
    shared = model["shared_attn"]
    x0 = common.embed_lookup(model["embed"], tb["tokens"])
    positions = torch.arange(SEQ).expand(BATCH, SEQ)

    def run(blocks):
        x = x0
        for i, lp in enumerate(model["mamba_layers"]):
            x = zamba._mamba_out(lp, x, cfg)
            if (i + 1) % cfg.hybrid_attn_every == 0:
                x, _ = zamba._shared_block(blocks[(i + 1) // cfg.hybrid_attn_every - 1], x, cfg,
                                           positions)
        return zamba._logits(model, x, cfg).square().mean()

    w = shared["attn"]["wq"].detach().clone().requires_grad_()
    copies = [w.clone().detach().requires_grad_() for _ in range(2)]
    blocks = [{"attn_norm": shared["attn_norm"], "ffn_norm": shared["ffn_norm"],
               "ffn": shared["ffn"], "attn": {**dict(shared["attn"].named_parameters()), "wq": c}}
              for c in copies]
    (g_shared,) = torch.autograd.grad(run([{**blocks[0], "attn": {**blocks[0]["attn"], "wq": w}}]
                                          * 2), [w])
    g0, g1 = torch.autograd.grad(run(blocks), copies)
    assert g0.abs().max() > 0 and g1.abs().max() > 0
    torch.testing.assert_close(g_shared, g0 + g1, rtol=1e-5, atol=1e-7)


def _stacked(state) -> dict:
    """The port's per-layer state lists stacked as the reference's tree."""
    return {"mamba": {k: torch.stack([s[k] for s in state["mamba"]]).numpy()
                      for k in ("ssm", "conv")},
            "attn": {k: torch.stack([c[k] for c in state["attn"]]).numpy() for k in ("k", "v")}}


def test_zamba_prefill_decode_and_states_equal_the_reference(carried):
    """Prefill 11 tokens, decode one, then a 4-token step with state (the
    Mamba2 layers' chunked SSD from h0; attention over the fresh tokens, as
    the reference's): logits and every state leaf."""
    jcfg, jparams, cfg, model = carried
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    jstate = jzamba.init_state(jcfg, 2, 24, jnp.float32)
    tstate = zamba.init_state(cfg, 2, 24, torch.float32)
    assert jax.tree.map(lambda a: a.shape, jstate) == \
        {k: {n: v.shape for n, v in d.items()} for k, d in _stacked(tstate).items()}
    steps = [(0, 11), (11, 12), (12, 16)]
    for lo, hi in steps:
        jt, tt = jnp.asarray(toks[:, lo:hi]), torch.from_numpy(toks[:, lo:hi])
        if lo == 0:
            jl, jstate = jzamba.prefill(jparams, {"tokens": jt}, jstate, jcfg)
            tl, out = zamba.prefill(model, {"tokens": tt}, tstate, cfg, q_chunk=8, kv_chunk=8)
        else:
            jl, jstate = jzamba.decode_step(jparams, {"tokens": jt}, jstate, jnp.int32(lo), jcfg)
            tl, out = zamba.decode_step(model, {"tokens": tt}, tstate, lo, cfg)
        assert out is tstate and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for (path, a), (_, b) in zip(common.tree_leaves(_stacked(tstate)),
                                     common.tree_leaves(jax.tree.map(np.asarray, jstate))):
            assert _max_err(a, b) <= 1e-5, (lo, "/".join(path))


def test_zamba_decode_matches_teacher_forcing(carried):
    """Decode logits against one forward over the prompt and the consumed
    tokens (teacher forcing)."""
    _, _, cfg, model = carried
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 14),
                                                              dtype=np.int32))
    state = zamba.init_state(cfg, 2, 16, torch.float32)
    lg, state = zamba.prefill(model, {"tokens": toks[:, :10]}, state, cfg)
    served = [lg]
    for t in range(10, 14):
        lg, state = zamba.decode_step(model, {"tokens": toks[:, t:t + 1]}, state, t, cfg)
        served.append(lg)
    x, none = zamba.forward(model, {"tokens": toks}, cfg)
    assert none is None
    teacher = zamba._logits(model, x, cfg)[:, 9:]
    torch.testing.assert_close(torch.cat(served, 1), teacher, rtol=1e-4, atol=1e-4)


def test_zamba_serve_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), got)


def test_zamba_train_step_equals_the_reference():
    """One AdamW step: the loss, grad norm and lr are the reference's, and
    so are the updated parameters and moments."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _tree(cfg, 1)
    jparams, model = jax.tree.map(jnp.asarray, tree), common.trainable(
        registry.params_from_reference(cfg, tree))
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=8, kv_chunk=8))(
        jparams, jadamw.init(jparams, jopt), jb)
    step = train_step.make_train_step(cfg, opt, q_chunk=8, kv_chunk=8)
    model, state, m = step(model, adamw.init(model, opt), tb)
    assert set(m) == set(jm) == {"loss", "nll", "grad_norm", "lr"}
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for k in ("m", "v"):  # the moments follow the gradients: 1e-3 of each leaf's max
        mine = dict(common.tree_leaves(registry.params_to_reference(cfg, state[k])))
        for path, w in common.tree_leaves(jax.tree.map(np.asarray, jstate[k])):
            assert _max_err(mine[path], w) <= 1e-3, (k, "/".join(path))
    # Adam's first step moves a parameter by lr * g / (|g| + eps) (+ decay):
    # ~lr = 1e-3 whatever |g|, except where |g| is near eps = 1e-8, whose
    # step follows that gradient's rounding.  So every parameter lies
    # within 2 lr of the reference's, and all but 1e-4 of a leaf's within
    # 1e-5 (1% of lr).
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, model)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jparams2)):
        off = np.abs(got[path] - w)
        assert off.max() <= 2 * opt.peak_lr and np.mean(off > 1e-5) <= 1e-4, "/".join(path)


def test_zamba_remat_gives_bitwise_equal_gradients(carried):
    """Recomputing each Mamba2 layer in the backward changes no bit."""
    _, _, cfg, model = carried
    tb, _ = _batch(2)
    model = common.trainable(model)
    try:
        runs = [train_step.make_grad_fn(cfg, remat=remat, q_chunk=8, kv_chunk=8)(model, tb)
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


def test_zamba_train_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Mirrors tests/test_train_serve_e2e.py::test_train_resume_continues_exactly
    on zamba, bitwise; the history has no ``aux`` (the hybrid has none)."""
    cfg = get_config(ARCH).reduced()
    quiet = lambda s: None  # noqa: E731
    straight = loop.train(cfg, _short(None, 4), log=quiet, device="cpu")
    first = loop.train(cfg, _short(str(tmp_path), 2), log=quiet, device="cpu")
    resumed = loop.train(cfg, _short(str(tmp_path), 4), log=quiet, device="cpu")
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    hist = first["history"] + resumed["history"]
    assert set(hist[0]) == {"step", "loss", "nll", "grad_norm", "lr"}
    for key in ("loss", "nll", "grad_norm"):
        assert [h[key] for h in hist] == [h[key] for h in straight["history"]]
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, a in straight["opt_state"][k].items():
            assert torch.equal(a, resumed["opt_state"][k][n]), (k, n)


# -- mirrors of zamba's cases in tests/test_arch_smoke.py ---------------------------------


def test_zamba_train_step_smoke():
    """Mirrors tests/test_arch_smoke.py::test_train_step_smoke[zamba2-1.2b]."""
    cfg = get_config(ARCH).reduced()
    api = registry.get(cfg)
    params = common.trainable(api.init(torch.Generator().manual_seed(0), cfg))
    batch = registry.make_inputs(cfg, ShapeConfig("smoke", 32, 2, "train"),
                                 torch.Generator().manual_seed(1))
    loss, _ = api.loss_fn(params, batch, cfg, remat=True, q_chunk=8, kv_chunk=8)
    assert loss.shape == () and np.isfinite(loss.item())
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_zamba_prefill_decode_smoke():
    """Mirrors tests/test_arch_smoke.py::test_prefill_decode_smoke[zamba2-1.2b]."""
    cfg = get_config(ARCH).reduced()
    api = registry.get(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    b, plen, max_len = 2, 16, 32
    state = api.init_state(cfg, b, max_len, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (b, plen), generator=torch.Generator().manual_seed(1))
    logits, state = api.prefill(params, {"tokens": toks}, state, cfg, q_chunk=8, kv_chunk=8)
    assert logits.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits2, state = api.decode_step(params, {"tokens": tok}, state, plen, cfg)
    assert logits2.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits2).all())


def test_zamba_full_config_dims_and_inputs():
    """zamba2-1.2b's full dims (tests/test_arch_smoke.py::test_exact_assigned_dims)
    and its train inputs."""
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size) == \
        (38, 2048, 32, 32, 8192, 32000)
    assert mamba2.dims(c) == (4096, 64, 64, 64, 4224) and c.head_dim == 64
    assert set(registry.input_specs(c, SHAPES["train_4k"])) == {"tokens", "labels"}


def test_zamba_clis_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: 2x4 tokens" in out and "step     2 loss" in out
    assert fa.LAUNCHES.count == before
