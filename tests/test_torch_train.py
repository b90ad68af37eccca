"""The port's training path against the JAX reference on the CPU: the flash
backward, the rmsnorm backward, ``loss_fn`` and its gradients, the train
step (microbatched, f32 and bf16 accumulation), three steps of training,
and remat on against off.  The loop's own behaviour (resume, the loss going
down, the CLI) is in ``test_torch_train_substrate.py``.

Inputs are made with numpy from a seed and handed to both packages; the
weights are the reference's, carried by ``registry.params_from_reference``,
on ``qwen3-4b.reduced()`` in f32.  The reference differentiates its chunked
attention by autodiff (its Pallas kernel cannot run here: it calls
``pl.load``, which the installed jax no longer has), so ``jax.vjp`` of
``repro.models.attention.flash_attention`` is the oracle of the backward.

Tolerances, f32: sums run in another order in the two frameworks (XLA's
fused scans against torch's chunked einsums), ~1e-7 relative per op.
Gradients are held within 1e-5 (attention) or 1e-4 (a whole model) of each
leaf's largest magnitude: an element near zero carries the rounding of the
large terms that cancelled in it, so the leaf's max is its scale.  Losses
within 1e-5 relative (one step) or 1e-4 (three steps of AdamW, which maps
each gradient element to about its sign).
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain_step
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, registry, transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "qwen3-4b"
SEQ, BATCH = 16, 4


def _max_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _configs(mtp: bool):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if mtp:
        jcfg, cfg = dataclasses.replace(jcfg, mtp_depth=1), dataclasses.replace(cfg, mtp_depth=1)
    return jcfg, cfg


def _carried(mtp: bool = False):
    """(reference cfg, reference params, port cfg, port model with grads on)."""
    jcfg, cfg = _configs(mtp)
    jparams = jregistry.get(jcfg).init(jax.random.PRNGKey(0), jcfg)
    model = registry.params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, common.trainable(model)


def _batch(step: int = 0, seq: int = SEQ, batch: int = BATCH, seed: int = 0):
    """The reference pipeline's numpy batch (tokens, labels, labels2)."""
    return JTokenPipeline(JDataConfig(512, seq, batch, seed=seed)).batch_at(step)


def _torch_batch(raw, mtp: bool):
    keys = ("tokens", "labels", "labels2") if mtp else ("tokens", "labels")
    return {k: torch.from_numpy(np.ascontiguousarray(raw[k])) for k in keys}


def _jax_batch(raw, mtp: bool):
    keys = ("tokens", "labels", "labels2") if mtp else ("tokens", "labels")
    return {k: jnp.asarray(raw[k]) for k in keys}


# -- the flash backward --------------------------------------------------------------

FLASH_CASES = [  # (b, sq, skv, hq, hkv, d, causal, q_offset)
    (2, 48, 48, 4, 4, 16, True, 0),  # G=1
    (2, 48, 48, 4, 2, 16, False, 0),  # G=2, non-causal
    (1, 37, 37, 8, 2, 32, True, 0),  # G=4, ragged
    (1, 20, 70, 4, 1, 16, True, 50),  # Sq < Skv, queries continuing a prefix
    (2, 33, 70, 8, 2, 16, False, 0),  # ragged both ways, non-causal
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_equals_the_reference_vjp(case):
    b, sq, skv, hq, hkv, d, causal, q_offset = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    dout = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=32, q_offset=q_offset)
    want_out, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a, **kw), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    assert lse.shape == (b, hq, sq)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, **kw)
    # the autograd function: the CPU path runs the plain versions
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (fa.LAUNCHES.count, fa.BWD_LAUNCHES.count)
    fa.flash_attention(*leaves, **kw).backward(tdo)
    assert (fa.LAUNCHES.count, fa.BWD_LAUNCHES.count) == before  # no kernel on the CPU
    for name, p, t, w in zip("qkv", plain, leaves, want):
        assert _max_err(p.numpy(), w) <= 1e-5, name
        assert torch.equal(t.grad, p), name


def test_serving_takes_the_forward_alone(monkeypatch):
    """No tensor requires grad when serving: neither autograd function runs."""
    def refuse(*args):
        raise AssertionError("an autograd function ran while serving")

    monkeypatch.setattr(fa.FlashAttention, "apply", refuse)
    monkeypatch.setattr(common.RMSNorm, "apply", refuse)
    cfg = get_config(ARCH).reduced()
    model = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    assert not any(p.requires_grad for p in model.parameters())
    x, _, _ = transformer.forward(model, {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, cfg)
    assert x.grad_fn is None


# -- rmsnorm, the loss's pieces ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_equals_the_reference(dtype):
    """The reference's custom VJP in both precisions: dx narrowed to x's
    dtype (bf16: within one bf16 ulp of dx's max), dw in f32."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    w = 1 + rng.standard_normal(64, dtype=np.float32) / 4
    g = rng.standard_normal((3, 5, 64), dtype=np.float32)
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b: jcommon.rmsnorm(a, b, 1e-6), jnp.asarray(x).astype(jdt),
                       jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = common.rmsnorm(tx, tw, 1e-6)
    y.backward(torch.from_numpy(g).to(tdt))
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    assert _max_err(y.detach().float().numpy(), np.asarray(out, np.float32)) <= tol
    assert _max_err(tx.grad.float().numpy(), np.asarray(jdx, np.float32)) <= tol
    assert _max_err(tw.grad.numpy(), np.asarray(jdw)) <= 1e-5


def test_cross_entropy_and_tied_embedding_gradients_equal_the_reference():
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((11, 6), dtype=np.float32)
    h = rng.standard_normal((2, 5, 6), dtype=np.float32)
    toks = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)

    def jloss(e, x):  # the embedding reached twice: the lookup and the logits
        y = x + jcommon.embed_lookup(e, jnp.asarray(toks))
        return jcommon.softmax_cross_entropy(y @ e.T, jnp.asarray(labels))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(h))
    te, th = (torch.from_numpy(a).requires_grad_() for a in (emb, h))
    y = th + common.embed_lookup(te, torch.from_numpy(toks))
    common.softmax_cross_entropy(y @ te.T, torch.from_numpy(labels)).backward()
    assert _max_err(te.grad.numpy(), want[0]) <= 1e-6
    assert _max_err(th.grad.numpy(), want[1]) <= 1e-6


# -- the loss and the train step --------------------------------------------------------


@pytest.mark.parametrize("mtp", [False, True], ids=["dense", "dense+mtp"])
def test_loss_fn_and_gradients_equal_the_reference(mtp):
    jcfg, jparams, cfg, model = _carried(mtp)
    raw = _batch()
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jregistry.get(jcfg).loss_fn(p, b, jcfg, q_chunk=8, kv_chunk=8),
        has_aux=True))(jparams, _jax_batch(raw, mtp))
    loss, metrics = registry.get(cfg).loss_fn(model, _torch_batch(raw, mtp), cfg, q_chunk=8,
                                              kv_chunk=8)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert set(metrics) == set(jm) == ({"nll", "aux", "loss", "mtp_nll"} if mtp
                                       else {"nll", "aux", "loss"})
    for key in jm:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7)
    got = registry.params_to_reference(cfg, dict(zip(names, grads)))
    want = jax.tree.map(np.asarray, jgrads)
    for path, w in common.tree_leaves(want):
        g = dict(common.tree_leaves(got))[path]
        assert _max_err(g, w) <= 1e-4, "/".join(path)


def test_params_to_reference_inverts_the_carry():
    _, jparams, cfg, model = _carried(mtp=True)
    back = registry.params_to_reference(cfg, model)
    for (path, a), (path2, b) in zip(common.tree_leaves(back),
                                     common.tree_leaves(jax.tree.map(np.asarray, jparams))):
        assert path == path2
        np.testing.assert_array_equal(a, b)
    named = dict(model.named_parameters())
    with pytest.raises(ValueError, match="does not know"):
        registry.params_to_reference(cfg, dict(named, stray=torch.zeros(1)))
    del named["layers.1.ffn.w_up"]
    with pytest.raises(ValueError, match="no leaf named layers.1.ffn.w_up"):
        registry.params_to_reference(cfg, named)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_microbatched_train_step_equals_the_reference(acc):
    """Two microbatches, gradients accumulated in ``acc``.  bf16: each
    gradient element is rounded to bf16 in both (a tie may round the other
    way), so the grad norm is held to 1e-3."""
    jcfg, jparams, cfg, model = _carried()
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    raw = _batch(1)
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, jadamw.AdamWConfig(**dataclasses.asdict(opt)),
                                                microbatches=2, grad_acc_dtype=acc, q_chunk=8,
                                                kv_chunk=8))
    _, _, jm = jstep(jparams, jadamw.init(jparams, jadamw.AdamWConfig()), _jax_batch(raw, False))
    step = train_step.make_train_step(cfg, opt, microbatches=2, grad_acc_dtype=acc, q_chunk=8,
                                      kv_chunk=8)
    _, _, m = step(model, adamw.init(model, opt), _torch_batch(raw, False))
    assert set(m) == set(jm)
    for key in jm:
        tol = 1e-3 if (acc == "bfloat16" and key == "grad_norm") else 1e-5
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=tol, atol=1e-7)


def test_three_train_steps_follow_the_reference():
    jcfg, jparams, cfg, model = _carried()
    opt = adamw.AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=3)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, jopt, q_chunk=8, kv_chunk=8))
    step = train_step.make_train_step(cfg, opt, q_chunk=8, kv_chunk=8)
    jstate, state = jadamw.init(jparams, jopt), adamw.init(model, opt)
    for i in range(3):
        raw = _batch(i)
        jparams, jstate, jm = jstep(jparams, jstate, _jax_batch(raw, False))
        model, state, m = step(model, state, _torch_batch(raw, False))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3


# -- the port's own loop ---------------------------------------------------------------


def test_remat_on_and_off_give_bitwise_equal_gradients():
    cfg = get_config(ARCH).reduced()
    model = common.trainable(transformer.init(torch.Generator().manual_seed(3), cfg))
    batch = _torch_batch(_batch(2), False)
    out = []
    for remat in (True, False):
        loss, _ = transformer.loss_fn(model, batch, cfg, remat=remat, q_chunk=8, kv_chunk=8)
        out.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*out):
        assert torch.equal(a, b)
