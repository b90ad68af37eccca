"""The port's MoE family against the JAX reference on the CPU: the MoE
layer (routing, the capacity dispatch, the combine, shared experts, the
aux-free router), the MoE transformer's loss, gradients, prefill, decode
and greedy serving, a train step with AdamW, the weight carry of trees
with ``moe_layers``, and training resumed bitwise.

Configs: ``granite-moe-1b-a400m.reduced()`` (4 MoE layers, 8 experts top-2,
softmax routing, tied embeddings; no ``layers`` stack), and the same with
one leading dense layer, one shared expert and the sigmoid aux-free router
(``layers`` + ``moe_layers``, ``router_bias``).  Every input is made with
numpy from a seed; the weights are the reference's, carried by
``registry.params_from_reference``.  The default capacity factor (1.25)
drops assignments at these sizes, so the drops are held to the
reference's too.

Tolerances, f32: sums in another order (XLA's against torch's), ~1e-7
relative per op: the layer's output and aux within 1e-5; losses within
1e-5 relative; gradients within 1e-3 of each leaf's largest magnitude
(an element near zero carries the rounding of the terms that cancelled in
it); logits within 1e-4.  bf16: each product rounds to
bf16 (2^-9 relative) in both, in other places: 1e-2 of the output's max.
Routing (the top-k indices and the slot buffers) is held equal.
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
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common, moe, registry, transformer
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import loop, train_step

ARCH = "granite-moe-1b-a400m"
SEQ, BATCH = 16, 4
MIXED = dict(n_dense_layers=1, n_shared_experts=1, router_aux_free=True, use_mla=False)


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the MoE layer ----------------------------------------------------------------------


def _moe_cfgs(**kw):
    """The reference's MoE test config (tests/test_ssm_and_moe.py:_moe_cfg)
    in both packages."""
    base = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32",
                n_experts=8, experts_per_token=2, n_shared_experts=1,
                d_ff_expert=32, capacity_factor=8.0)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _moe_params(jcfg, seed: int = 0, bias: bool = False):
    """(reference params, the port's: the same arrays as torch tensors).
    ``bias`` puts a nonzero router_bias in, so that it moves the choice."""
    jp = jcommon.init_params(jmoe.spec(jcfg), jax.random.PRNGKey(seed))
    if bias and jcfg.router_aux_free:
        jp["router_bias"] = jnp.asarray(
            np.random.default_rng(seed).standard_normal(jcfg.n_experts, dtype=np.float32) / 10)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("aux_free", [False, True])
def test_moe_matches_dense_oracle(aux_free):
    """Mirrors tests/test_ssm_and_moe.py::test_moe_matches_dense_oracle."""
    jcfg, cfg = _moe_cfgs(router_aux_free=aux_free)
    _, params = _moe_params(jcfg)
    x = torch.from_numpy(_x((2, 16, 64), 1))
    out, aux = moe.apply(params, x, cfg)
    np.testing.assert_allclose(out.numpy(), moe.moe_ref(params, x, cfg).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert np.isfinite(aux.item())


def test_moe_chunked_matches_unchunked():
    jcfg, cfg = _moe_cfgs()
    _, params = _moe_params(jcfg)
    x = torch.from_numpy(_x((2, 64, 64), 2))
    out_c, aux_c = moe.apply(params, x, cfg, token_chunk=16)
    out_u, _ = moe.apply(params, x, cfg, token_chunk=10**9)
    np.testing.assert_allclose(out_c.numpy(), out_u.numpy(), rtol=1e-5, atol=1e-6)
    # aux is the mean of the chunks' (the reference's scan)
    want = torch.stack([moe.apply(params, x[:, i:i + 16], cfg)[1] for i in range(0, 64, 16)])
    assert aux_c.item() == pytest.approx(want.mean().item(), rel=1e-6)


def test_moe_capacity_drops_tokens():
    """At capacity_factor -> 0 every expert keeps one slot per group; only
    the shared-expert path remains for the rest."""
    jcfg, cfg = _moe_cfgs(capacity_factor=1e-9, n_shared_experts=0)
    _, params = _moe_params(jcfg)
    x = torch.from_numpy(_x((2, 16, 64), 1))
    out, _ = moe.apply(params, x, cfg)
    assert torch.mean(torch.abs(out)) < torch.mean(torch.abs(moe.moe_ref(params, x, cfg)))
    w, idx, _ = moe._route(params, x, cfg)
    tok, _ = moe._dispatch_indices(idx, 16, cfg, moe.capacity(16, cfg))
    assert tok.shape == (2, 8, 1) and int((tok < 16).sum()) <= 2 * 8


@hypothesis.settings(deadline=None, max_examples=10)
@hypothesis.given(seed=st.integers(0, 2**31 - 1))
def test_moe_dispatch_weight_conservation(seed):
    """Each token's combine weights sum to 1 (normalized), and every kept
    assignment sits in exactly one slot of its own expert."""
    jcfg, cfg = _moe_cfgs()
    _, params = _moe_params(jcfg, seed % 1000)
    x = torch.from_numpy(_x((1, 8, 64), seed))
    w, idx, _ = moe._route(params, x, cfg)
    s = w.sum(-1).numpy()
    assert np.all(s <= 1.0 + 1e-5) and np.all(s >= 0.99)
    cap = moe.capacity(8, cfg)
    tok, ks = moe._dispatch_indices(idx, 8, cfg, cap)
    maps = moe._slot_maps(tok, ks, 8, cfg.experts_per_token)
    kept = maps.assignment_row[:, 0] < cfg.n_experts * cap
    assert int(kept.sum()) == int((tok < 8).sum())
    rows = maps.assignment_row[kept, 0]
    assert torch.equal(maps.assignment[rows, 0], torch.nonzero(kept)[:, 0])
    assert torch.equal(rows // cap, idx.reshape(-1)[kept])  # the slot's expert is the choice's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aux_free", [False, True], ids=["softmax", "sigmoid-aux-free"])
def test_moe_apply_equals_the_reference(aux_free, dtype):
    """Capacity factor 1.0 at 32 tokens a group: some experts overflow, so
    the drops are held to the reference's as well as the kept slots."""
    jcfg, cfg = _moe_cfgs(router_aux_free=aux_free, capacity_factor=1.0)
    jp, params = _moe_params(jcfg, seed=3, bias=True)
    x = _x((2, 32, 64), 4)
    jx, tx = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    _, jidx, _ = jmoe._route(jp, jx, jcfg)
    _, idx, _ = moe._route(params, tx, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    cap = moe.capacity(32, cfg)
    jtok, jk = jmoe._dispatch_indices(jidx, 32, jcfg, cap)
    tok, ks = moe._dispatch_indices(idx, 32, cfg, cap)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
    assert int((tok < 32).sum()) < 2 * 32 * cfg.experts_per_token  # something was dropped
    jout, jaux = jmoe.apply(jp, jx, jcfg)
    out, aux = moe.apply(params, tx, cfg)
    assert out.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    else:  # silu rounds once here, twice in jax.nn.silu (x * sigmoid(x)): within 1e-2 of the max
        assert _max_err(out.float().numpy(), np.asarray(jout, np.float32)) <= 1e-2
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rows_in,rows_out,m", [(7, 5, 1), (6, 9, 3)])
def test_gather_rows_backward_passes_gradcheck(rows_in, rows_out, m):
    """The dispatch/combine function's hand-written backward (a gather
    through the transpose map) against finite differences in f64.  The
    maps are a random partial assignment: each output row reads m source
    rows or the zero row, and ``back`` lists, per source row, the output
    rows that read it."""
    rng = np.random.default_rng(rows_in * 10 + m)
    index = rng.integers(0, rows_in + 1, (rows_out, m))  # rows_in: the zero row
    readers = [[i for i in range(rows_out) for j in range(m) if index[i, j] == n]
               for n in range(rows_in)]
    width = max(1, max(len(r) for r in readers))
    back = np.full((rows_in, width), rows_out)
    for n, r in enumerate(readers):
        back[n, :len(r)] = r
    src = torch.from_numpy(rng.standard_normal((rows_in, 3))).requires_grad_()
    ti, tb = torch.from_numpy(index), torch.from_numpy(back)
    assert torch.autograd.gradcheck(lambda s: moe._GatherRows.apply(s, ti, tb), (src,))
    out = moe._GatherRows.apply(src, ti, tb)
    assert out.grad_fn is not None and torch.equal(out, moe.gather_rows_plain(src.detach(), ti))


# -- the MoE transformer -----------------------------------------------------------------


def _configs(mixed: bool):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if mixed:
        jcfg, cfg = dataclasses.replace(jcfg, **MIXED), dataclasses.replace(cfg, **MIXED)
    return jcfg, cfg


def _tree(cfg, seed: int) -> dict:
    """The reference's tree with numpy weights: zeros, ones, or
    ``scale * N(0, 1)`` with the spec's scale, else 0.05.  (The reference's
    init takes 1/sqrt(shape[0]), the layer count for a stacked leaf: std
    0.5 here, MoE outputs of hundreds from inputs of a few and a saturated
    attention softmax, which amplify f32 rounding layer by layer.  At 0.05
    activations stay O(1).)"""
    rng, tree = np.random.default_rng(seed), {}
    for path, s in common.tree_leaves(transformer.spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = (rng.standard_normal(s.shape) * (s.scale or 0.05)).astype(np.float32)
        common.tree_set(tree, path, x)
    return tree


def _carry(mixed: bool, seed: int):
    """(reference cfg, reference params, port cfg, port model), the same
    weights on both sides."""
    jcfg, cfg = _configs(mixed)
    tree = _tree(cfg, seed)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, registry.params_from_reference(cfg, tree)


@pytest.fixture(scope="module", params=[False, True], ids=["granite-moe", "dense+moe+shared"])
def carried(request):
    """(reference cfg, reference params, port cfg, port model)."""
    return _carry(request.param, seed=0)


def _batch(step: int = 0):
    raw = JTokenPipeline(JDataConfig(512, SEQ, BATCH, seed=0)).batch_at(step)
    return ({k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in ("tokens", "labels")},
            {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")})


def test_moe_tree_and_weight_carry(carried):
    """The tree has ``moe_layers`` (and ``layers`` only with a leading dense
    layer); every leaf is carried and the carry round-trips exactly."""
    jcfg, jparams, cfg, model = carried
    tree = jax.tree.map(np.asarray, jparams)
    assert set(tree) == set(transformer.spec(cfg)) == set(jtransformer.spec(jcfg))
    assert [p for p, _ in common.tree_leaves(tree)] == \
        [p for p, _ in common.tree_leaves(jregistry.get(jcfg).spec(jcfg))]
    assert ("layers" in tree) == bool(cfg.n_dense_layers) and "moe_layers" in tree
    assert len(model["moe_layers"]) == cfg.n_layers - cfg.n_dense_layers
    assert common.count_params(model) == sum(int(x.size) for x in jax.tree.leaves(jparams))
    back = registry.params_to_reference(cfg, model)
    got, want = common.tree_leaves(back), common.tree_leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))
    named = dict(model.named_parameters())
    del named["moe_layers.1.moe.router"]
    with pytest.raises(ValueError, match="no leaf named moe_layers.1.moe.router"):
        registry.params_to_reference(cfg, named)
    with pytest.raises(ValueError, match="left over"):
        registry.params_from_reference(cfg, dict(tree, stray=np.zeros(3, np.float32)))


def test_moe_loss_and_gradients_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    tb, jb = _batch()
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
    assert (float(jm["aux"]) > 0) == (not cfg.router_aux_free)  # aux-free routing: aux = 0
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = dict(common.tree_leaves(registry.params_to_reference(cfg, grads)))
    for path, w in common.tree_leaves(jax.tree.map(np.asarray, jgrads)):
        if path[-1] == "router_bias":  # read detached: a zero gradient in both
            assert not np.any(w) and not np.any(got[path])
            continue
        assert _max_err(got[path], w) <= 1e-3, "/".join(path)
    assert any(p[-1] == "router" for p in got)


def test_moe_prefill_and_decode_logits_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jstate = jtransformer.init_state(jcfg, 2, 16, jnp.float32)
    tstate = transformer.init_state(cfg, 2, 16, torch.float32)
    assert set(tstate) == set(jstate)
    jl, jstate = jtransformer.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11])}, jstate, jcfg,
                                      q_chunk=8, kv_chunk=8)
    tl, tstate = transformer.prefill(model, {"tokens": torch.from_numpy(toks[:, :11])}, tstate,
                                     cfg, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jl, _ = jtransformer.decode_step(jparams, {"tokens": jnp.asarray(toks[:, 11:])}, jstate,
                                     jnp.int32(11), jcfg)
    tl, _ = transformer.decode_step(model, {"tokens": torch.from_numpy(toks[:, 11:])}, tstate,
                                    11, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_moe_serve_greedy_tokens_equal_the_reference(carried):
    jcfg, jparams, cfg, model = carried
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    want = JServeEngine(jcfg, jparams, JServeConfig(max_len=32)).generate(prompts, 6)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), got)


def test_moe_train_step_keeps_router_bias_at_zero():
    """One AdamW step on the mixed tree: the loss, grad norm and lr are the
    reference's; router_bias gets a zero gradient, stays 0 (weight decay of
    0) and its moments stay 0 in both; the step counts agree."""
    jcfg, jparams, cfg, model = _carry(mixed=True, seed=1)
    model = common.trainable(model)
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    tb, jb = _batch(1)
    jparams2, jstate, jm = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=8, kv_chunk=8))(
        jparams, jadamw.init(jparams, jopt), jb)
    step = train_step.make_train_step(cfg, opt, q_chunk=8, kv_chunk=8)
    model, state, m = step(model, adamw.init(model, opt), tb)
    for key in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    assert int(state["count"]) == int(jstate["count"]) == 1
    names = [n for n in state["m"] if n.endswith("router_bias")]
    assert len(names) == cfg.n_layers - cfg.n_dense_layers
    for n in names:
        assert not torch.any(dict(model.named_parameters())[n])
        assert not torch.any(state["m"][n]) and not torch.any(state["v"][n])
    assert not np.any(np.asarray(jparams2["moe_layers"]["moe"]["router_bias"]))
    assert not np.any(np.asarray(jstate["m"]["moe_layers"]["moe"]["router_bias"]))
    assert not np.any(np.asarray(jstate["v"]["moe_layers"]["moe"]["router_bias"]))


def _short(tmp, steps):
    return loop.TrainConfig(steps=steps, seq_len=SEQ, global_batch=2, log_every=1,
                            checkpoint_dir=tmp, checkpoint_every=100,
                            opt=adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4))


def test_moe_train_resumed_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """Mirrors tests/test_train_serve_e2e.py::test_train_resume_continues_exactly
    on granite-moe, bitwise."""
    cfg = get_config(ARCH).reduced()
    quiet = lambda s: None  # noqa: E731
    straight = loop.train(cfg, _short(None, 4), log=quiet, device="cpu")
    first = loop.train(cfg, _short(str(tmp_path), 2), log=quiet, device="cpu")
    resumed = loop.train(cfg, _short(str(tmp_path), 4), log=quiet, device="cpu")
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    hist = first["history"] + resumed["history"]
    for key in ("loss", "nll", "aux"):
        assert [h[key] for h in hist] == [h[key] for h in straight["history"]]
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in hist)
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, a in straight["opt_state"][k].items():
            assert torch.equal(a, resumed["opt_state"][k][n]), (k, n)


def test_moe_clis_on_the_cpu(capsys):
    before = fa.LAUNCHES.count
    serve_cli.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--tokens", "4",
                    "--device", "cpu"])
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--seq-len", "16",
                    "--global-batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: 2x4 tokens" in out and "step     2 loss" in out
    assert fa.LAUNCHES.count == before
