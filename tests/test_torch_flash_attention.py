"""The port's attention (plain chunked version, the wrapper's CPU path) against
the JAX reference: the chunked ``models.attention.flash_attention`` and the
full-materialisation oracle ``kernels.ref.flash_attention_ref``.

The Pallas kernel cannot be the oracle: it calls ``pl.load``, which the
installed jax no longer has.  Inputs are made with numpy from a seed and
handed to both packages.  The (Hq, Hkv) x causal grid, the chunk sweep, the
bf16 case and their tolerances (2e-5 at f32, 5e-2 at bf16) mirror
``tests/test_flash_kernel.py``; the ragged case mirrors
``tests/test_attention_and_mla.py::test_flash_ragged_lengths``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import roofline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn


def _qkv(b, sq, skv, hq, hkv, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, dv or d), dtype=np.float32))


def _port(q, k, v, **kw):
    return tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_vs_reference(hq, hkv, causal):
    q, k, v = _qkv(2, 64, 64, hq, hkv, 32, seed=hq * 7 + hkv + int(causal))
    before = fa.LAUNCHES.count
    out = _port(q, k, v, causal=causal, q_chunk=16, kv_chunk=32)
    assert fa.LAUNCHES.count == before  # the CPU path launches nothing
    chunked = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, q_chunk=16, kv_chunk=32)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal)
    np.testing.assert_allclose(out, np.asarray(chunked), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_chunk,kv_chunk", [(16, 16), (32, 64), (64, 32)])
def test_flash_chunk_sweep(q_chunk, kv_chunk):
    q, k, v = _qkv(1, 128, 128, 4, 4, 16, seed=q_chunk + kv_chunk)
    out = _port(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_flash_bf16():
    q, k, v = _qkv(2, 64, 64, 4, 4, 32, seed=0)
    out = tattn.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                q_chunk=16, kv_chunk=32)
    assert out.dtype == torch.bfloat16
    bf = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v)]
    oracle = jref.flash_attention_ref(*(jnp.asarray(x) for x in bf))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(oracle), rtol=5e-2, atol=5e-2)
    chunked = jattn.flash_attention(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                                    q_chunk=16, kv_chunk=32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(chunked, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flash_ragged_lengths():
    q, k, v = _qkv(2, 30, 30, 4, 4, 8, seed=1)
    out = _port(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv,causal,q_offset", [
    (24, 40, False, 0),  # Sq != Skv, non-causal
    (16, 40, True, 24),  # queries continuing a 24-token prefix
    (40, 24, False, 0),
])
def test_flash_offsets_and_unequal_lengths_vs_chunked_reference(sq, skv, causal, q_offset):
    """The kernel's convention (positions from q_offset), against the
    reference's chunked path; the oracle aligns the ends instead."""
    q, k, v = _qkv(2, sq, skv, 8, 2, 32, seed=sq + skv)
    kw = {"causal": causal, "q_chunk": 16, "kv_chunk": 16, "q_offset": q_offset}
    out = _port(q, k, v, **kw)
    chunked = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(out, np.asarray(chunked), rtol=2e-5, atol=2e-5)
    if causal and q_offset == skv - sq:  # here the two conventions coincide
        oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        np.testing.assert_allclose(out, np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_flash_value_dim_may_differ_on_the_cpu():
    q, k, v = _qkv(1, 32, 32, 4, 2, 32, seed=3, dv=16)
    out = _port(q, k, v, q_chunk=16, kv_chunk=16)
    chunked = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    q_chunk=16, kv_chunk=16)
    assert out.shape == (1, 32, 4, 16)
    np.testing.assert_allclose(out, np.asarray(chunked), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(16, 16), (8, 24)])
def test_attention_oracle_vs_reference_oracle(causal, sq, sk):
    q, k, v = _qkv(2, sq, sk, 8, 2, 16, seed=5)
    out = tref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_rmsnorm_oracle_vs_reference_oracle():
    rng = np.random.default_rng(6)
    x, w = rng.standard_normal((3, 5, 64), dtype=np.float32), rng.standard_normal(64, dtype=np.float32)
    out = tref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.rmsnorm_ref(jnp.asarray(x),
                                                                       jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)


def test_smem_budget_at_the_main_path_shape():
    """The kernel's shared memory per block fits Hopper's 227 KB per block
    (232,448 bytes), twice per SM (228 KB less 1 KB reserved per block) at
    the prefill shape's D=128."""
    per_block = fa.smem_bytes(128)
    assert per_block <= 232448
    assert 2 * (per_block + 1024) <= 228 * 1024
    assert fa.smem_bytes(32) < fa.smem_bytes(64) < per_block


def test_wrapper_rejects_other_devices_and_mismatched_operands():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 4, 2, 32, seed=7))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="dtype|float"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="Hkv dividing"):
        fa.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v[:, :, :1].expand(1, 8, 3, 32))


def test_attention_bound_counts_visible_pairs():
    for sq, skv, off in [(5, 5, 0), (5, 8, 0), (8, 5, 0), (5, 5, 3), (7, 3, 10), (1, 1, 0)]:
        brute = sum(min(skv, max(0, i + off + 1)) for i in range(sq))
        assert roofline.visible_pairs(sq, skv, causal=True, q_offset=off) == brute
    assert roofline.visible_pairs(5, 8, causal=False) == 40
    bound = roofline.attention_bound(batch=4, sq=1024, skv=1024, hq=32, hkv=8, d=128,
                                     hw=roofline.H100_SXM)
    assert bound.flops == 4 * 4 * 32 * 128 * (1024 * 1025 // 2)  # 34.4 GFLOP
    assert bound.bytes == 2 * 4 * (2 * 1024 * 32 * 128 + 2 * 1024 * 8 * 128)  # 84 MB
    assert bound.bound_by == "operations"
    assert abs(bound.bound_s - bound.flops / 989e12) < 1e-12
    f32 = roofline.attention_bound(batch=4, sq=1024, skv=1024, hq=32, hkv=8, d=128,
                                   dtype=torch.float32, hw=roofline.H100_SXM)
    assert abs(f32.compute_s - f32.flops / 67e12) < 1e-12
