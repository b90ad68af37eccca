"""Decode against a teacher-forced pass, zamba2-1.2b at full width on the
CPU, in the reference and in the port on the same weights.

Serving decodes token by token from a state (the Mamba2 recurrence, the
KV caches); the teacher runs one cache-less forward over the same tokens.
In exact arithmetic their logits agree.  In bf16 they part: the two round
in other places, and each layer carries the difference on.  This file
measures that gap (``max |served - teacher|`` over the teacher's largest
logit) in both packages, and the port's served logits against the
reference's:

* bf16 at the reference's init rule (``init_params``: 1/sqrt of a leaf's
  first dimension, which for a stacked Mamba2 leaf is the full model's
  38 layers);
* f32 at the same rule;
* bf16 with the matrices at std 0.02 (the embedding and head at their
  spec's scale), as the card's smoke serves them.

The cut: the full width (d_model 2,048, 64 SSM heads of 64, state 64,
the shared block's 32 heads of 64 and d_ff 8,192, vocab 32,000), 13 of the
38 layers (2 groups of 6 with the shared block after each, 1 tail layer);
one sequence of 32 prompt tokens and 8 decoded ones, random tokens from
a seed (no greedy choice, so both packages consume the same tokens).

Held: in bf16 the port parts from its teacher by at most 1.25x what the
reference parts from its own (the gap is the reference's arithmetic, not
the port's); in f32 both gaps and the port against the reference lie
within 1e-3 of the logits' range (f32 sums in another order through 13
layers at the reference's init, where activations grow layer by layer).
``pytest -s`` prints the numbers.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import zamba as jzamba
from repro_torch.configs import get_config
from repro_torch.models import common, registry, zamba

ARCH = "zamba2-1.2b"
CUT = {"n_layers": 13, "hybrid_attn_every": 6}
PROMPT, NEW = 32, 9  # the prefill's logits, then 8 decode steps: positions 31 .. 39


@pytest.fixture(scope="module")
def unit_tree() -> dict:
    """The cut's tree: zeros and ones as the spec says, N(0, 1) elsewhere."""
    cfg = dataclasses.replace(get_config(ARCH), **CUT)
    rng, tree = np.random.default_rng(0), {}
    for path, s in common.tree_leaves(zamba.spec(cfg)):
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, float(s.init == "ones"), np.float32)
        else:
            x = rng.standard_normal(s.shape, dtype=np.float32)
        common.tree_set(tree, path, x)
    return tree


def _scaled(unit: dict, rule: str) -> dict:
    """``unit`` at the reference's rule for the full model, or with the
    matrices at 0.02; a leaf with a scale in the spec keeps it."""
    full = dict(common.tree_leaves(zamba.spec(get_config(ARCH))))
    tree = {}
    for path, x in common.tree_leaves(unit):
        s = full[path]
        if s.init in ("zeros", "ones"):
            std = 1.0
        elif s.scale is not None:
            std = s.scale
        else:
            std = 1.0 / math.sqrt(s.shape[0]) if rule == "reference" else 0.02
        common.tree_set(tree, path, x * np.float32(std))
    return tree


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reference(tree: dict, toks: np.ndarray, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """(served, teacher) logits of the reference, positions PROMPT-1 ..."""
    cfg = dataclasses.replace(jget_config(ARCH), dtype=dtype, **CUT)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)
    b, n = toks.shape
    prefill = jax.jit(lambda p, t, s: jzamba.prefill(p, {"tokens": t}, s, cfg))
    decode = jax.jit(lambda p, t, s, c: jzamba.decode_step(p, {"tokens": t}, s, c, cfg))
    teacher = jax.jit(lambda p, t: jzamba._logits(
        p, jzamba.forward(p, {"tokens": t}, cfg)[0][:, PROMPT - 1:], cfg))
    lg, state = prefill(params, jnp.asarray(toks[:, :PROMPT]),
                        jzamba.init_state(cfg, b, n, jnp.float32))
    served = [lg]
    for t in range(PROMPT, n):
        lg, state = decode(params, jnp.asarray(toks[:, t:t + 1]), state, jnp.int32(t))
        served.append(lg)
    return (np.asarray(jnp.concatenate(served, 1).astype(jnp.float32)),
            np.asarray(teacher(params, jnp.asarray(toks)).astype(jnp.float32)))


def _port(tree: dict, toks: np.ndarray, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """(served, teacher) logits of the port, as :func:`_reference`."""
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype, **CUT)
    model = registry.params_from_reference(cfg, tree).to(getattr(torch, dtype))
    b, n = toks.shape
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        lg, state = zamba.prefill(model, {"tokens": tt[:, :PROMPT]}, zamba.init_state(
            cfg, b, n, torch.float32), cfg)
        served = [lg]
        for t in range(PROMPT, n):
            lg, state = zamba.decode_step(model, {"tokens": tt[:, t:t + 1]}, state, t, cfg)
            served.append(lg)
        x, _ = zamba.forward(model, {"tokens": tt}, cfg)
        teacher = zamba._logits(model, x[:, PROMPT - 1:], cfg)
    return torch.cat(served, 1).float().numpy(), teacher.float().numpy()


@pytest.mark.parametrize("rule,dtype", [("reference", "bfloat16"), ("reference", "float32"),
                                        ("0.02", "bfloat16")])
def test_port_parts_from_its_teacher_as_the_reference_does(unit_tree, rule, dtype):
    tree = _scaled(unit_tree, rule)
    toks = np.random.default_rng(1).integers(0, 32000, (1, PROMPT + NEW - 1), dtype=np.int32)
    j_served, j_teacher = _reference(tree, toks, dtype)
    t_served, t_teacher = _port(tree, toks, dtype)
    found = {"rule": rule, "dtype": dtype, "layers": CUT["n_layers"],
             "reference_gap": _rel(j_served, j_teacher), "port_gap": _rel(t_served, t_teacher),
             "served_port_vs_reference": _rel(t_served, j_served),
             "teacher_port_vs_reference": _rel(t_teacher, j_teacher),
             "logit_range": float(np.abs(j_teacher).max())}
    print(json.dumps(found))
    assert np.isfinite(t_served).all() and np.isfinite(t_teacher).all()
    if dtype == "bfloat16":
        assert found["port_gap"] <= 1.25 * found["reference_gap"], found
    else:
        assert max(found["reference_gap"], found["port_gap"],
                   found["served_port_vs_reference"]) <= 1e-3, found
