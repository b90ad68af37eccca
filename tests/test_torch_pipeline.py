"""The port's GPipe schedule over logical stages (``distributed/pipeline.py``)
on the CPU: against the port's sequential pass bit for bit, values and
gradients, for S in {1, 2, 4} stages and fewer, as many and more
microbatches than stages; against the reference's ``sequential_reference``
on the same numpy inputs within the reference test's own bounds (values
1e-5, gradients 1e-4: f32 sums in another order in the two frameworks);
and with stages of reduced-qwen3 transformer layers (the flash kernel's
plain version, the rmsnorm backward) against both.

The reference's ``pipeline_forward`` runs over a 4-device mesh
(``tests/test_pipeline_parallel.py`` forces host devices in a subprocess);
its ``sequential_reference`` needs none, so it runs in this process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import pipeline as jpipeline
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.distributed import pipeline
from repro_torch.models import common, transformer
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)


def _tanh_params(n_stages: int, d: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)}


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _values_and_grads(fn, params: dict[str, np.ndarray], x: np.ndarray, stage_fn, **kw):
    """fn's output and the gradient of its sum of squares, per leaf."""
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    out = fn(tp, torch.from_numpy(x), stage_fn, **kw)
    grads = torch.autograd.grad((out**2).sum(), list(tp.values()))
    return out.detach(), dict(zip(tp, grads))


@pytest.mark.parametrize("n_stages,n_micro", [
    (1, 1), (1, 3), (2, 1), (2, 2), (2, 5), (4, 2), (4, 4), (4, 6)])
def test_pipeline_equals_sequential_bitwise(n_stages, n_micro):
    """M < S, M = S and M > S (S = 1 has no M < S): the schedule applies
    each stage to each microbatch in the sequential pass's order, so the
    outputs and every gradient are the same bits."""
    params = _tanh_params(n_stages, 16, seed=10 * n_stages + n_micro)
    x = np.random.default_rng(n_micro).standard_normal((n_micro, 2, 16)).astype(np.float32)
    got, got_g = _values_and_grads(pipeline.pipeline_forward, params, x, _tanh_stage,
                                   stages=n_stages)
    want, want_g = _values_and_grads(pipeline.sequential_reference, params, x, _tanh_stage)
    assert got.shape == (n_micro, 2, 16)
    assert torch.equal(got, want)
    for name in params:
        assert torch.equal(got_g[name], want_g[name]), name


def test_pipeline_matches_the_reference_sequential_pass():
    """The reference test's problem (S=4, M=6, mb=2, d=16): the port's
    pipeline against the reference's ``sequential_reference`` under
    ``jax.grad``, on the same numpy inputs."""
    params = _tanh_params(4, 16, seed=0)
    x = np.random.default_rng(2).standard_normal((6, 2, 16)).astype(np.float32)
    got, got_g = _values_and_grads(pipeline.pipeline_forward, params, x, _tanh_stage, stages=4)

    def jstage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jpipeline.sequential_reference(jp, jnp.asarray(x), jstage)
    want_g = jax.grad(lambda p: jnp.sum(jpipeline.sequential_reference(p, jnp.asarray(x),
                                                                       jstage) ** 2))(jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for name in params:
        np.testing.assert_allclose(got_g[name].numpy(), np.asarray(want_g[name]), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_pipeline_rejects_a_wrong_stage_count():
    params = {k: torch.from_numpy(v) for k, v in _tanh_params(2, 4, seed=1).items()}
    x = torch.zeros((3, 1, 4))
    with pytest.raises(ValueError, match="stages=4"):
        pipeline.pipeline_forward(params, x, _tanh_stage, stages=4)
    with pytest.raises(ValueError, match="disagree"):
        pipeline.pipeline_forward({"w": params["w"], "b": params["b"][:1]}, x, _tanh_stage)
    with pytest.raises(ValueError, match="no microbatch"):
        pipeline.pipeline_forward(params, x[:0], _tanh_stage)


STAGES, LAYERS, MICRO, SEQ = 2, 2, 3, 12  # 4 reduced-qwen3 layers in 2 stages


def _layer_stack_params(cfg, seed: int) -> dict:
    """Numpy leaves (STAGES, LAYERS, ...) of the dense layer's spec: weights
    at 0.1 N(0, 1), norms at 1 + 0.1 N(0, 1)."""
    spec = common.stack_specs(common.stack_specs(transformer.layer_spec(cfg, moe_layer=False),
                                                 LAYERS), STAGES)
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, s in common.tree_leaves(spec):
        x = rng.standard_normal(s.shape).astype(np.float32) * np.float32(0.1)
        common.tree_set(out, path, x + np.float32(1.0) if s.init == "ones" else x)
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def test_pipeline_of_reduced_qwen3_layers():
    """Two stages of two reduced-qwen3 layers each over three microbatches of
    one 12-token sequence: bitwise against the port's sequential pass,
    values and the gradient of every leaf, and against the reference's
    ``sequential_reference`` over its own ``layer_apply`` within 1e-5
    (values) and 1e-4 of each leaf's largest gradient."""
    cfg, jcfg = get_config("qwen3-4b").reduced(), jget_config("qwen3-4b").reduced()
    params = _layer_stack_params(cfg, seed=3)
    x = np.random.default_rng(4).standard_normal((MICRO, 1, SEQ, cfg.d_model)).astype(np.float32)
    pos = torch.arange(SEQ)

    def stage(p, h):
        for i in range(LAYERS):
            h = transformer.layer_apply(_tree_map(lambda t: t[i], p), h, cfg, positions=pos,
                                        moe_layer=False)[0]
        return h

    def run(fn, **kw):
        tp = _tree_map(lambda a: torch.from_numpy(a).requires_grad_(), params)
        leaves = [t for _, t in common.tree_leaves(tp)]
        out = fn(tp, torch.from_numpy(x), stage, **kw)
        return out.detach(), torch.autograd.grad((out**2).sum(), leaves)

    got, got_g = run(pipeline.pipeline_forward, stages=STAGES)
    want, want_g = run(pipeline.sequential_reference)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))

    jpos = jnp.arange(SEQ)

    def jstage(p, h):
        for i in range(LAYERS):
            h = jtransformer.layer_apply(jax.tree.map(lambda t: t[i], p), h, jcfg,
                                         positions=jpos, moe_layer=False)[0]
        return h

    jp = jax.tree.map(jnp.asarray, params)
    jx = jnp.asarray(x)
    jwant = jpipeline.sequential_reference(jp, jx, jstage)
    jgrads = jax.grad(lambda p: jnp.sum(jpipeline.sequential_reference(p, jx, jstage) ** 2))(jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-5, rtol=1e-5)
    names = [common.path_name(p) for p, _ in common.tree_leaves(params)]
    jflat = {common.path_name(p): np.asarray(g) for p, g in common.tree_leaves(jgrads)}
    for name, g in zip(names, got_g):
        err = np.abs(g.numpy() - jflat[name]).max() / max(np.abs(jflat[name]).max(), 1e-30)
        assert err < 1e-4, (name, err)
