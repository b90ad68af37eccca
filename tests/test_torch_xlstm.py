"""The port's xLSTM family against the JAX reference on the CPU: the two
cells (exponential gating with the stabilizer ``m``, at large gate
pre-activations too), ``mlstm_apply`` and ``slstm_apply`` with and without
a state, a full pass against step-by-step decode, and xlstm-125m's reduced
model (4 blocks, sLSTM at 1 and 3): the loss and every gradient, prefill
logits and every state leaf, decode, greedy serving, a train step with
AdamW, the weight carry (``blocks`` is a list: index order), remat,
training resumed bitwise, and both CLIs.

Every input is made with numpy from a seed; the model's weights are a
numpy tree by the reference's init rule (``_tree``), carried by
``registry.params_from_reference``.

Tolerances, f32: sums in another order (XLA's against torch's), ~1e-7
relative per op.  A cell step and the mixers within 1e-5 of each output's
max; the stabilizer's exponentials amplify nothing (every gate is
``exp(x - m_new)`` <= 1).  Logits within 1e-4; losses within 1e-5
relative; gradients within 1e-3 of each leaf's largest magnitude (an
element near zero carries the rounding of the terms that cancelled in
it), or of 1e-4 of the tree's largest where the leaf's is smaller
(``_leaf_err``): a block's input-gate bias ``b_i`` has a gradient of
exactly 0 wherever no step clamps ``|n.q|`` at 1 (a common shift of the
input gate scales C and n alike, which cancels in h), so there both
packages hold rounding noise (6e-10 against 0.05 in a first block
drawn by the reference's ``init_params``).  After one
AdamW step the moments as the gradients, the parameters as that test
states.  A full pass against
step-by-step decode: rtol 1e-3, atol 2e-4, the reference's own test's
tolerance (tests/test_ssm_and_moe.py::test_xlstm_parity).
"""
import dataclasses

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
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.models import xlstm_model as jxlstm_model
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, registry, xlstm, xlstm_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import loop, train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "xlstm-125m"
SEQ, BATCH = 16, 2
KINDS = {"mlstm": (jxlstm.mlstm_spec, xlstm.mlstm_apply, xlstm.mlstm_init_state,
                   jxlstm.mlstm_apply, jxlstm.mlstm_init_state),
         "slstm": (jxlstm.slstm_spec, xlstm.slstm_apply, xlstm.slstm_init_state,
                   jxlstm.slstm_apply, jxlstm.slstm_init_state)}


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_err(got, want, scale: float) -> float:
    """max |got - want| over the larger of the leaf's largest |want| and
    1e-4 of ``scale``, the tree's largest (see the module's docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-4 * scale, 1e-30))


def _tree_max(tree) -> float:
    return max(float(np.abs(x).max()) for _, x in common.tree_leaves(tree))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _normal(seed: int, *shape, std: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# -- the cells ------------------------------------------------------------------------------


def test_log_forget_equals_the_reference_at_large_f():
    """log sigmoid(f) and its gradient against the reference's
    ``-softplus(-f)`` out to |f| = 100, where torch's ``softplus`` (the
    identity above its threshold 20) would differ."""
    f = np.concatenate([np.linspace(-100.0, 100.0, 401), [-30.5, -20.0, 20.0, 30.5]]
                       ).astype(np.float32)
    want = np.asarray(-jax.nn.softplus(-jnp.asarray(f)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(-jax.nn.softplus(-x)))(jnp.asarray(f)))
    t = torch.from_numpy(f).requires_grad_()
    got = xlstm._log_forget(t)
    (got_g,) = torch.autograd.grad(got.sum(), t)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(got_g), want_g, rtol=1e-6, atol=1e-30)
    assert _np(got)[0] == -100.0 and -1e-30 < _np(got)[400] <= 0.0


def test_mlstm_cell_equals_the_reference():
    """One step from a nonzero state with gate pre-activations of std 8 and
    the stabilizer m of std 4: exponential gates near overflow without m."""
    b, h, p = 2, 3, 8
    carry = (_normal(1, b, h, p, p), _normal(2, b, h, p), _normal(3, b, h, std=4.0))
    qkvif = (_normal(4, b, h, p), _normal(5, b, h, p), _normal(6, b, h, p),
             _normal(7, b, h, std=8.0), _normal(8, b, h, std=8.0))
    (jc, jn, jm), jh = jxlstm._mlstm_cell(tuple(map(jnp.asarray, carry)),
                                          tuple(map(jnp.asarray, qkvif)))
    (c, n, m), h_t = xlstm._mlstm_cell(tuple(map(torch.from_numpy, carry)),
                                       *map(torch.from_numpy, qkvif))
    for name, got, want in (("c", c, jc), ("n", n, jn), ("m", m, jm), ("h", h_t, jh)):
        assert _max_err(_np(got), want) <= 1e-5, name


def test_slstm_cell_equals_the_reference():
    """One step from a nonzero state, gate pre-activations of std 8."""
    jcfg, cfg = _small_cfgs()
    d_inner, h, p = xlstm._dims(cfg)
    jp = jcommon.init_params(jxlstm.slstm_spec(jcfg), jax.random.PRNGKey(3))
    jp = dict(jp, r_gates=jnp.asarray(_normal(9, 4, h, p, p, std=0.5)),
              b_gates=jnp.asarray(_normal(10, 4, d_inner)))
    carry = tuple(_normal(11 + i, 2, d_inner, std=4.0 if i == 2 else 1.0) for i in range(4))
    x_t = _normal(15, 2, 4, d_inner, std=8.0)
    jcarry, jh = jxlstm._slstm_cell(jp, jcfg, tuple(map(jnp.asarray, carry)), jnp.asarray(x_t))
    tcarry, h_t = xlstm._slstm_cell(xlstm._recurrent(torch.from_numpy(np.array(jp["r_gates"]))),
                                    tuple(map(torch.from_numpy, carry)),
                                    torch.from_numpy(x_t) + torch.from_numpy(np.array(
                                        jp["b_gates"])))
    for name, got, want in zip(("c", "n", "m", "h", "out"), tcarry + (h_t,), jcarry + (jh,)):
        assert _max_err(_np(got), want) <= 1e-5, name


# -- the mixers ------------------------------------------------------------------------------


def _small_cfgs():
    """The reference's parity config (tests/test_ssm_and_moe.py::test_xlstm_parity)
    in both packages: d_model 64, 4 heads of 32."""
    base = dict(name="x", family="ssm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=0, vocab_size=97, dtype="float32", ssm_expand=2, ssm_conv=4)
    return JModelConfig(**base), ModelConfig(**base)


def _mixer(kind: str, seed: int = 0):
    jcfg, cfg = _small_cfgs()
    jp = jcommon.init_params(KINDS[kind][0](jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["no-state", "decode", "prefill-with-state"])
def test_apply_equals_the_reference(kind, mode):
    """The mixer's output and new state against the reference's, from a
    nonzero state (its first 8 tokens' prefill) where there is one: within
    1e-5 of each one's max."""
    jcfg, cfg, jp, params = _mixer(kind, seed=7)
    _, apply, init_state, japply, jinit_state = KINDS[kind]
    x = _normal(8, 2, 20, 64)
    rest = {"no-state": None, "decode": slice(8, 9), "prefill-with-state": slice(8, 20)}[mode]

    def run(fn, p, c, xs, init):
        if rest is None:
            return fn(p, xs, c)
        _, st_ = fn(p, xs[:, :8], c, state=init(c, 2))
        return fn(p, xs[:, rest], c, state=st_)

    jy, jst = run(japply, jp, jcfg, jnp.asarray(x), jinit_state)
    y, tst = run(apply, params, cfg, torch.from_numpy(x), init_state)
    assert (tst is None) == (rest is None)
    found = {"out": (_np(y), jy)}
    if tst is not None:
        assert set(tst) == set(jst)
        found.update({name: (_np(tst[name]), jst[name]) for name in tst})
    for name, (got, want) in found.items():
        assert got.shape == want.shape, name
        assert _max_err(got, want) <= 1e-5, name


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_parity(kind):
    """Mirrors tests/test_ssm_and_moe.py::test_xlstm_parity: a full pass
    equals 12 one-token steps from a zero state."""
    _, cfg, _, params = _mixer(kind)
    _, apply, init_state, _, _ = KINDS[kind]
    x = torch.from_numpy(_normal(1, 2, 12, 64))
    y_full, none = apply(params, x, cfg)
    st_ = init_state(cfg, 2)
    outs = []
    for t in range(12):
        o, st_ = apply(params, x[:, t:t + 1], cfg, state=st_)
        outs.append(o)
    assert none is None
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(), rtol=1e-3, atol=2e-4)
    assert bool(torch.isfinite(y_full).all())


def test_mixers_keep_the_f32_cell_in_a_bf16_model():
    """A bf16 model: the cells' states stay f32 (the reference's
    ``astype(f32)`` of q, k, v and the gates), outputs come back bf16, and
    the states round to the state's dtype only on the way out."""
    for kind in ("mlstm", "slstm"):
        _, cfg, _, params = _mixer(kind)
        _, apply, init_state, _, _ = KINDS[kind]
        x = torch.from_numpy(_normal(2, 2, 6, 64)).to(torch.bfloat16)
        y, st_ = apply(params, x, cfg, state=init_state(cfg, 2))
        assert y.dtype == torch.bfloat16 and all(v.dtype == torch.float32 for v in st_.values())
        _, st16 = apply(params, x, cfg, state=init_state(cfg, 2, torch.bfloat16))
        assert all(v.dtype == torch.bfloat16 for v in st16.values())
        assert all(torch.equal(st16[k], st_[k].to(torch.bfloat16)) for k in st16), kind


# -- xlstm-125m reduced -----------------------------------------------------------------------


def _tree(cfg, seed: int) -> dict:
    """The reference's tree with numpy weights by the reference's rule:
    zeros, ones, or ``scale * N(0, 1)`` with the spec's scale, else
    1/sqrt(shape[0]) (no xLSTM leaf is stacked)."""
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(xlstm_model.spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = (rng.standard_normal(s.shape) * (s.scale or s.shape[0] ** -0.5)).astype(np.float32)
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


def test_registry_returns_xlstm_and_the_reduced_shape(carried):
    _, _, cfg, model = carried
    api = registry.get(cfg)
    assert api is registry._XLSTM and api.loss_fn is xlstm_model.loss_fn
    assert cfg.slstm_layers == (1, 3) and len(model["blocks"]) == cfg.n_layers == 4
    assert [("r_gates" in dict(b["cell"].named_parameters())) for b in model["blocks"]] == \
        [False, True, False, True]
    assert api.stack_sizes(cfg) == {}


def test_xlstm_tree_and_weight_carry(carried):
    """Every leaf is carried both ways, exactly; ``blocks`` is a list walked
    in index order (``blocks/10`` after ``blocks/9``, not after
    ``blocks/1``), as ``jax.tree`` flattens it."""
    jcfg, jparams, cfg, model = carried
    tree = jax.tree.map(np.asarray, jparams)
    paths = [p for p, _ in common.tree_leaves(tree)]
    assert paths == [p for p, _ in common.tree_leaves(jregistry.get(jcfg).spec(jcfg))]
    assert [common.path_name(p) for p in paths] == \
        ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
         for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert common.count_params(model) == sum(int(x.size) for x in jax.tree.leaves(jparams))
    back = registry.params_to_reference(cfg, model)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 4
    got, want = common.tree_leaves(back), common.tree_leaves(tree)
    assert [p for p, _ in got] == paths
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=common.path_name(path))
    named = dict(model.named_parameters())
    del named["blocks.3.cell.r_gates"]
    with pytest.raises(ValueError, match="no leaf named blocks.3.cell.r_gates"):
        registry.params_to_reference(cfg, named)
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, dict(tree, stray=np.zeros(3, np.float32)))


def test_twelve_blocks_carry_in_index_order():
    """xlstm-125m's 12 blocks (sLSTM at 5 and 11): the tree's leaves walk
    blocks 0, 1, ..., 9, 10, 11, and a numpy tree with each block's leaves
    marked by its index comes back on the same block."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=16, n_heads=2, vocab_size=11)
    spec = xlstm_model.spec(cfg)
    blocks = [p[1] for p, _ in common.tree_leaves(spec) if p[0] == "blocks"]
    assert sorted(set(blocks)) == list(range(12)) and blocks == sorted(blocks)
    tree = {}
    for path, s in common.tree_leaves(spec):
        mark = float(path[1]) if path[0] == "blocks" else -1.0
        common.tree_set(tree, path, np.full(s.shape, mark, np.float32))
    model = registry.params_from_reference(cfg, tree)
    for i, bp in enumerate(model["blocks"]):
        assert all(bool((p == i).all()) for p in bp.parameters()), i
    assert "r_gates" in dict(model["blocks"][11]["cell"].named_parameters())
    back = registry.params_to_reference(cfg, model)
    assert [float(b["norm"][0]) for b in back["blocks"]] == [float(i) for i in range(12)]


def test_xlstm_loss_and_gradients_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch()
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg), has_aux=True))(jparams, jb)
    model = common.trainable(model)
    try:
        grads, metrics = train_step.make_grad_fn(cfg)(model, tb)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jm) == {"nll", "loss"}
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    want = jax.tree.map(np.asarray, jgrads)
    for path, w in common.tree_leaves(want):
        assert _leaf_err(got[path], w, _tree_max(want)) <= 1e-3, common.path_name(path)
    assert np.any(got[("blocks", 1, "cell", "r_gates")])


def test_xlstm_prefill_decode_and_states_equal_the_reference(carried):
    """Prefill 11 tokens, decode one, then a 4-token step with state:
    logits and every state leaf of every block."""
    jcfg, jparams, cfg, model = carried
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    jstate = jxlstm_model.init_state(jcfg, 2, 24, jnp.float32)
    tstate = xlstm_model.init_state(cfg, 2, 24, torch.float32)
    assert [{k: tuple(v.shape) for k, v in s.items()} for s in tstate] == \
        [{k: v.shape for k, v in s.items()} for s in jstate]
    for lo, hi in [(0, 11), (11, 12), (12, 16)]:
        jt, tt = jnp.asarray(toks[:, lo:hi]), torch.from_numpy(toks[:, lo:hi])
        if lo == 0:
            jl, jstate = jax.jit(jxlstm_model.prefill, static_argnums=3)(
                jparams, {"tokens": jt}, jstate, jcfg)
            tl, tstate = xlstm_model.prefill(model, {"tokens": tt}, tstate, cfg)
        else:
            jl, jstate = jax.jit(jxlstm_model.decode_step, static_argnums=4)(
                jparams, {"tokens": jt}, jstate, jnp.int32(lo), jcfg)
            tl, tstate = xlstm_model.decode_step(model, {"tokens": tt}, tstate, lo, cfg)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for i, (a, b) in enumerate(zip(tstate, jstate)):
            assert set(a) == set(b)
            for name in a:
                assert _max_err(_np(a[name]), b[name]) <= 1e-5, (lo, i, name)


def test_xlstm_decode_matches_teacher_forcing(carried):
    """Decode logits against one state-less forward over the prompt and
    the consumed tokens (teacher forcing)."""
    _, _, cfg, model = carried
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 14),
                                                              dtype=np.int32))
    state = xlstm_model.init_state(cfg, 2)
    lg, state = xlstm_model.prefill(model, {"tokens": toks[:, :10]}, state, cfg)
    served = [lg]
    for t in range(10, 14):
        lg, state = xlstm_model.decode_step(model, {"tokens": toks[:, t:t + 1]}, state, t, cfg)
        served.append(lg)
    x, none = xlstm_model.forward(model, {"tokens": toks}, cfg)
    assert none is None
    teacher = xlstm_model._logits(model, x, cfg)[:, 9:]
    torch.testing.assert_close(torch.cat(served, 1), teacher, rtol=1e-4, atol=1e-4)


def test_xlstm_serve_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), got)


def test_xlstm_train_step_equals_the_reference():
    """One AdamW step: the loss, grad norm and lr are the reference's, and
    so are the updated parameters and moments."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = _tree(cfg, 1)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = common.trainable(registry.params_from_reference(cfg, tree))
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt))(
        jparams, jadamw.init(jparams, jopt), jb)
    model, state, m = train_step.make_train_step(cfg, opt)(model, adamw.init(model, opt), tb)
    assert set(m) == set(jm) == {"loss", "nll", "grad_norm", "lr"}
    for key in jm:
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for k in ("m", "v"):  # the moments follow the gradients: 1e-3 of each leaf's max
        mine = dict(common.tree_leaves(registry.params_to_reference(cfg, state[k])))
        want = jax.tree.map(np.asarray, jstate[k])
        for path, w in common.tree_leaves(want):
            assert _leaf_err(mine[path], w, _tree_max(want)) <= 1e-3, (k, common.path_name(path))
    # Adam's first step moves a parameter by ~lr whatever |g|, except where
    # |g| is near eps = 1e-8: every parameter within 2 lr of the
    # reference's; all but 1e-4 of a leaf's within 1e-5 (1% of lr), leaving
    # out the elements whose gradient is rounding noise (the first moment,
    # (1 - b1) g, below 1e-4 of its tree's largest: the vanishing b_i),
    # whose step is that noise over eps
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, model)))
    m_ref = jax.tree.map(np.asarray, jstate["m"])
    m_floor = 1e-4 * _tree_max(m_ref)
    m_ref = dict(common.tree_leaves(m_ref))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jparams2)):
        off = np.abs(got[path] - w)
        kept = off[np.abs(m_ref[path]) >= m_floor]
        assert off.max() <= 2 * opt.peak_lr, common.path_name(path)
        assert kept.size == 0 or np.mean(kept > 1e-5) <= 1e-4, common.path_name(path)


def test_xlstm_remat_gives_bitwise_equal_gradients(carried):
    """Recomputing each block in the backward changes no bit."""
    _, _, cfg, model = carried
    tb, _ = _batch(2)
    model = common.trainable(model)
    try:
        runs = [train_step.make_grad_fn(cfg, remat=remat)(model, tb) for remat in (True, False)]
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


def test_xlstm_train_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Mirrors tests/test_train_serve_e2e.py::test_train_resume_continues_exactly
    on xLSTM, bitwise."""
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


# -- mirrors of xlstm's cases in tests/test_arch_smoke.py and test_train_serve_e2e.py --------


def test_xlstm_train_step_smoke():
    """Mirrors tests/test_arch_smoke.py::test_train_step_smoke[xlstm-125m]."""
    cfg = get_config(ARCH).reduced()
    api = registry.get(cfg)
    params = common.trainable(api.init(torch.Generator().manual_seed(0), cfg))
    batch = registry.make_inputs(cfg, ShapeConfig("smoke", 32, 2, "train"),
                                 torch.Generator().manual_seed(1))
    loss, _ = api.loss_fn(params, batch, cfg, remat=True)
    assert loss.shape == () and np.isfinite(loss.item())
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_xlstm_serves_identical_prompts_identically():
    """Mirrors tests/test_train_serve_e2e.py::test_serve_hybrid_and_ssm_families
    for xlstm-125m: tokens in the vocabulary, the same twice."""
    cfg = get_config(ARCH).reduced()
    params = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32), device="cpu")
    out = eng.generate(np.ones((2, 4), np.int32), 4)
    assert out.shape == (2, 8) and np.all(out >= 0) and np.all(out < cfg.vocab_size)
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(eng.generate(np.ones((2, 4), np.int32), 4), out)


def test_xlstm_full_config_dims_and_parameters():
    """xlstm-125m's full dims (tests/test_arch_smoke.py::test_exact_assigned_dims):
    212,002,640 parameters by the spec (the name counts 125 M), the
    reference's count; and its train inputs."""
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size) == \
        (12, 768, 4, 4, 0, 50304)
    assert c.slstm_layers == (5, 11) and xlstm._dims(c) == (1536, 4, 384)
    n = sum(int(np.prod(s.shape)) for _, s in common.tree_leaves(xlstm_model.spec(c)))
    jspec = jxlstm_model.spec(jget_config(ARCH))
    assert n == 212_002_640 == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jspec, is_leaf=lambda x: isinstance(x, jcommon.ParamSpec)))
    assert set(registry.input_specs(c, SHAPES["train_4k"])) == {"tokens", "labels"}


def test_xlstm_clis_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: 2x4 tokens" in out and "step     2 loss" in out
    assert fa.LAUNCHES.count == before
