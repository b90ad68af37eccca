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
import math

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


@pytest.mark.parametrize("dtype,blocks_per_sm", [(torch.bfloat16, 1), (torch.float32, 2)])
def test_smem_budget_at_the_main_path_shape(dtype, blocks_per_sm):
    """Each body's shared memory per block fits Hopper's 227 KB per block
    (232,448 bytes) at the prefill shape's D=128, ``blocks_per_sm`` times
    per SM (228 KB less 1 KB reserved per block): the bf16 body's Q tile
    and three stages of K and V (230,512 bytes) once, the f32 body's 112 KB
    twice."""
    per_block = fa.smem_bytes(128, dtype)
    assert per_block <= 232448
    assert blocks_per_sm * (per_block + 1024) <= 228 * 1024
    assert fa.smem_bytes(32, dtype) < fa.smem_bytes(64, dtype) < per_block
    if dtype == torch.bfloat16:  # Q, K and V tiles in bf16
        stages = fa.tiling(dtype, 128)[2]
        assert per_block >= 2 * 128 * 128 * (fa.TC_GROUP_Q_STAGES[128] + 2 * stages)


def test_smem_budget_at_mla_heads():
    """At MLA's (D, Dv) = (192, 128) the bf16 body's Q tile and three stages
    of K (192 columns) and V (128) would take 289 KB; the persistent
    ``flash_mla_fwd`` takes two K and two V stages, each with its own full
    and empty barrier, and Q's pair: 214,096 bytes, one block per SM.  The
    f32 body's 144 KB fits once."""
    bf16 = fa.smem_bytes(192, torch.bfloat16, dv=128)
    assert fa.tiling(torch.bfloat16, 192, 128) == (128, 128, 2)
    assert bf16 == 1024 + 2 * 128 * 192 + 2 * 2 * 128 * (192 + 128) + 8 * (4 * 2 + 2) == 214096
    assert bf16 + 1024 <= 228 * 1024 and bf16 <= 232448
    assert 1024 + 2 * 128 * 192 + 3 * 2 * 128 * (192 + 128) > 232448  # three stages do not fit
    f32 = fa.smem_bytes(192, torch.float32, dv=128)
    assert f32 == 4 * (192 * 64 + 192 * 64 + 128 * 64 + 64 * 64) == 147456 <= 232448
    assert fa.smem_bytes(128, torch.bfloat16, dv=128) == fa.smem_bytes(128) == 230512
    assert list(fa.BWD_HEAD_DIMS) == list(fa.HEAD_DIMS)  # the backward at every pair


def test_smem_budget_and_tiling_of_the_persistent_d64_forward():
    """bf16 at D = Dv = 64 is ``flash_group_fwd<64>``: work items of 128
    folded rows against key tiles of 128, two Q stages and three K and three
    V stages, each with its own full and empty barrier: 132,224 bytes, one
    block per SM.  At D = 128 (``flash_group_fwd<128>``) one Q stage and
    three K and three V stages: 230,512 bytes (two Q stages would take
    263,296, past the 232,448 of a block).  The other pairs keep their
    bodies' numbers."""
    bf16 = torch.bfloat16
    assert fa.tiling(bf16, 64) == fa.tiling(bf16, 64, 64) == (128, 128, 3)
    d64 = fa.smem_bytes(64, bf16)
    assert d64 == 1024 + 2 * 2 * 128 * 64 + 3 * 2 * 128 * 64 * 2 + 8 * (4 * 3 + 2 * 2) == 132224
    assert d64 + 1024 <= 228 * 1024 and d64 <= 232448
    assert fa.smem_bytes(32, bf16) == 1024 + 2 * 32 * 128 + 3 * 2 * 128 * 64 + 16 * 3 == 58416
    assert fa.smem_bytes(128, bf16) == 230512 and fa.tiling(bf16, 128) == (128, 128, 3)
    assert fa.smem_bytes(128, bf16) == 1024 + (1 + 2 * 3) * 128 * 128 * 2 + 8 * (4 * 3 + 2 * 1)
    assert 1024 + (2 + 2 * 3) * 128 * 128 * 2 + 8 * (4 * 3 + 2 * 2) == 263296 > 232448
    assert fa.smem_bytes(192, bf16, dv=128) == 214096
    assert fa.tiling(bf16, 192, 128) == (128, 128, 2)
    assert fa.smem_bytes(64, torch.float32) == 4 * (64 * 64 * 3 + 64 * 64) == 65536
    assert fa.tiling(torch.float32, 64) == (64, 64, 1)


@pytest.mark.parametrize("d,dtype,g,rows", [
    (64, torch.bfloat16, 1, 128), (64, torch.bfloat16, 2, 128), (64, torch.bfloat16, 3, 126),
    (64, torch.bfloat16, 6, 126), (64, torch.bfloat16, 128, 128), (64, torch.float32, 3, 64),
    (128, torch.bfloat16, 3, 126), (128, torch.bfloat16, 48, 96), (128, torch.bfloat16, 8, 128),
    (128, torch.float32, 3, 64), (32, torch.bfloat16, 3, 128),
])
def test_row_tiles_hold_whole_query_groups_only_in_the_d64_forward(d, dtype, g, rows):
    """``flash_group_fwd``'s work items (bf16 at D = 64 and 128) hold
    G * (128 // G) folded rows, whole query groups, so that one TMA box of
    128 // G queries of G heads loads each 64 columns of an item's Q; the
    other bodies' blocks hold their rows whatever G is."""
    assert fa.tile_rows(dtype, d, g) == rows


def test_executed_flops_of_the_d64_forward_count_its_work_items():
    bf16_pair = 2 * 64 + 4 * 64  # QK^T, then P V twice (p_hi and p_lo)
    # granite-moe's prefill: G=2, items of 64 queries; item i sees i // 2 + 1
    # key tiles: 2 * (1 + ... + 8) = 72 per kv head
    assert fa.executed_flops(4, 1024, 1024, 16, 8, 64) == 4 * 8 * 72 * 128 * 128 * bf16_pair
    # zamba2-1.2b's shared block: G=1, item i sees i + 1 tiles: 36 per head
    assert fa.executed_flops(4, 1024, 1024, 32, 32, 64) == 4 * 32 * 36 * 128 * 128 * bf16_pair
    # G=3: 999 folded rows in items of 126 (42 queries); their last queries
    # 41, 83, 125, 167, 209, 251, 293 and 332 see 1, 1, 1, 2, 2, 2, 3, 3 tiles;
    # each item runs 128 rows wide
    assert fa.executed_flops(1, 333, 333, 12, 4, 64) == 4 * 15 * 128 * 128 * bf16_pair
    # whisper-tiny's encoder: 12 items of 128 rows a head, 12 key tiles each
    assert fa.executed_flops(4, 1500, 1500, 6, 6, 64, causal=False) == (
        4 * 6 * 12 * 12 * 128 * 128 * bf16_pair)
    # f32 at D=64, G=3: blocks of 64 rows, whole groups or not
    assert fa.executed_flops(1, 333, 333, 12, 4, 64, dtype=torch.float32) == (
        4 * sum((min(r + 64, 999) - 1) // 3 // 64 + 1 for r in range(0, 999, 64))
        * 64 * 64 * (2 * 64 + 2 * 64))


def test_executed_flops_of_the_d128_forward_count_whole_group_items():
    """At D=128 the forward's items hold whole query groups too: qwen3-4b's
    prefill (G=4, items of 32 queries: item i sees i // 4 + 1 key tiles, 144
    a kv head), granite-34b's G=48 (items of two queries, 96 rows run 128
    wide: 512 items a head at S=1,024, item i sees i // 64 + 1 tiles)."""
    bf16_pair = 2 * 128 + 4 * 128  # QK^T, then P V twice (p_hi and p_lo)
    assert fa.executed_flops(4, 1024, 1024, 32, 8, 128) == 4 * 8 * 144 * 128 * 128 * bf16_pair
    assert fa.executed_flops(1, 1024, 1024, 48, 1, 128) == (
        sum(i // 64 + 1 for i in range(512)) * 128 * 128 * bf16_pair)


@pytest.mark.parametrize("dtype,d,dv,fwd,bwd", [
    (torch.bfloat16, 128, 128, "flash_group_fwd<128>", "flash_bwd_d128"),
    (torch.bfloat16, 64, 64, "flash_group_fwd<64>", "flash_bwd_d64"),
    (torch.bfloat16, 32, 32, "flash_attention_tc", "flash_bwd_dq_tc"),
    (torch.bfloat16, 192, 128, "flash_mla_fwd", "flash_bwd_dq_mla"),
    (torch.float32, 128, 128, "flash_attention_kernel", "flash_bwd_dq"),
])
def test_kernel_names_count_launches_by_kernel(dtype, d, dv, fwd, bwd):
    """``kernel_name`` names the kernel a call runs, as
    ``LAUNCHES_BY_KERNEL`` counts it on the card; a CPU call runs the plain
    version and counts nothing."""
    assert fa.kernel_name(dtype, d, dv) == fwd
    assert fa.kernel_name(dtype, d, dv, backward=True) == bwd
    before = dict(fa.LAUNCHES_BY_KERNEL)
    q = torch.zeros((1, 4, 2, 32))
    fa.flash_attention(q, q, q)
    assert fa.LAUNCHES_BY_KERNEL == before


def test_cuda_checks_hold_the_d64_forward_to_groups_of_128_heads():
    """A row tile of ``flash_group_fwd`` (bf16 at D = 64 and 128) holds
    whole query groups, at most 128 heads; a larger G raises before a
    launch.  The other bodies take any G.  The checks read shapes, strides
    and addresses only, so they run here."""
    for d in (64, 128):
        q = torch.zeros((1, 4, 129, d), dtype=torch.bfloat16)
        k = torch.zeros((1, 4, 1, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"D = {d} holds whole query groups of at most 128"):
            fa._check_cuda(q, k, k, 0)
        fa._check_cuda(q[:, :, :128], k, k, 0)
        fa._check_cuda(q.float(), k.float(), k.float(), 0)
    q32 = torch.zeros((1, 4, 129, 32), dtype=torch.bfloat16)
    k32 = torch.zeros((1, 4, 1, 32), dtype=torch.bfloat16)
    fa._check_cuda(q32, k32, k32, 0)


SPLIT_FORMS = [  # (batch, sq, skv, heads, rope_heads, causal, q_offset, q_chunk, kv_chunk)
    (2, 37, 37, 3, 1, True, 0, 8, 16),
    (2, 37, 37, 3, 3, True, 0, 8, 16),
    (1, 20, 45, 4, 1, False, 0, 8, 16),  # ragged, Sq < Skv
    (1, 20, 45, 4, 4, False, 0, 512, 1024),
    (2, 11, 27, 2, 1, True, 16, 4, 8),  # queries continuing a 16-token prefix
    (1, 11, 27, 2, 2, True, 16, 4, 8),
]


def _split_parts(form, nope=8, rope=4, dv=6, dtype=torch.float32):
    b, sq, skv, h, hr = form[:5]
    rng = np.random.default_rng(sum(form[:5]))
    shapes = ((b, sq, h, nope), (b, sq, h, rope), (b, skv, h, nope), (b, skv, hr, rope),
              (b, skv, h, dv))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype) for s in shapes]


@pytest.mark.parametrize("form", SPLIT_FORMS)
def test_split_entry_equals_the_concatenated_plain_version(form):
    """``flash_attention_split`` on MLA's parts (q_nope, q_rope, k_nope, a
    k_rope of one head or of every head, v) gives the bits of
    ``flash_attention`` on the concatenated q and k (k_rope broadcast), and
    so do its five gradients through autograd: dq's parts, dk_nope, and
    dk_rope (for one rope head, its heads' gradients summed, as autograd of
    the broadcast sums them)."""
    causal, q_offset, q_chunk, kv_chunk = form[5:]
    kw = dict(causal=causal, q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk)
    parts = [t.requires_grad_() for t in _split_parts(form)]
    out = fa.flash_attention_split(*parts, **kw)
    ref = [t.detach().clone().requires_grad_() for t in parts]
    b, skv, h = ref[2].shape[:3]
    q = torch.cat([ref[0], ref[1]], dim=-1)
    k = torch.cat([ref[2], ref[3].expand(b, skv, h, ref[3].shape[-1])], dim=-1)
    want = fa.flash_attention(q, k, ref[4], **kw)
    assert out.shape == want.shape and torch.equal(out, want)
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(out.shape), dtype=np.float32))
    out.backward(dout)
    want.backward(dout)
    for got, w in zip(parts, ref):
        assert got.grad.shape == got.shape and torch.equal(got.grad, w.grad)
    # without grad: the forward alone, the same bits
    with torch.no_grad():
        assert torch.equal(fa.flash_attention_split(*parts, **kw), want)


def test_split_entry_checks_its_parts():
    """The parts' shapes must fit together: one kv head a query head, k_rope
    of one head or of every head, the nope and rope widths of q and k
    equal."""
    qn, qr, kn, kr, v = _split_parts((1, 8, 8, 4, 1))
    fa.flash_attention_split(qn, qr, kn, kr, v)
    with pytest.raises(ValueError, match="k_rope"):
        fa.flash_attention_split(qn, qr, kn, kr.expand(1, 8, 2, 4), v)
    with pytest.raises(ValueError, match="q_nope"):
        fa.flash_attention_split(qn, qr[..., :2], kn, kr, v)
    with pytest.raises(ValueError, match="lie on"):
        fa.flash_attention_split(qn, qr, kn, kr.double(), v)


def _tensor_core_body(q, k, v, *, causal, split=True):
    """The bf16 body's arithmetic, emulated on the CPU: tiles of 128 keys;
    q . k from the bf16 operands (exact products, f32 sums); the mask and
    the online softmax in f32 on these raw scores, with D^-1/2 applied in
    f32 inside the exponent, p = 2^(s c - m c), c = D^-1/2 log2(e); p as
    bf16(p) + bf16(p - bf16(p)) (or one bf16 p), each part multiplied into
    V in f32; one output rounding."""
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    c = d**-0.5 * math.log2(math.e)
    qf = q.float().reshape(b, sq, hkv, g, d)
    pos = torch.arange(sq)
    m = torch.full((b, hkv, g, sq), fa.NEG_INF)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, dv))
    for key0 in range(0, skv, fa.TC_KEYS):
        kt, vt = k[:, key0:key0 + fa.TC_KEYS].float(), v[:, key0:key0 + fa.TC_KEYS].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt)
        if causal:
            keys = key0 + torch.arange(kt.shape[1])
            s = s.masked_fill(keys[None, :] > pos[:, None], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        parts = (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", part, vt)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(torch.bfloat16)


ROUNDING_FORMS = [  # (batch, seq, hq, hkv, d, causal)
    (1, 256, 8, 2, 128, True),
    (1, 512, 8, 2, 64, False),
    (2, 300, 16, 2, 32, True),
]


def _bf16_qkv(form, seed):
    b, s, hq, hkv, d, _ = form
    return [torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(b, s, s, hq, hkv, d, seed)]


@pytest.mark.parametrize("form", ROUNDING_FORMS)
def test_split_probabilities_keep_the_kernel_tolerance(form):
    """The bf16 body's design (scale after the product, p split in two bf16
    parts) stays within ``kernel_tolerance(bf16)`` of the plain version."""
    q, k, v = _bf16_qkv(form, seed=sum(form[:5]))
    got = _tensor_core_body(q, k, v, causal=form[-1])
    want = fa.flash_attention_plain(q, k, v, causal=form[-1])
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_split_probabilities_keep_the_kernel_tolerance_at_mla_heads():
    """The same at MLA's prefill heads, (D, Dv) = (192, 128), G = 1: the
    bf16 body's arithmetic does not depend on the two widths."""
    rng = np.random.default_rng(192)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
               for s in ((1, 300, 4, 192), (1, 300, 4, 192), (1, 300, 4, 128)))
    got = _tensor_core_body(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert got.shape == want.shape == (1, 300, 4, 128)
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_one_bf16_probability_breaks_the_kernel_tolerance():
    """Why p is split: with one bf16 p, many outputs land more than the
    tolerance away from the plain version."""
    form = ROUNDING_FORMS[0]
    q, k, v = _bf16_qkv(form, seed=sum(form[:5]))
    got = _tensor_core_body(q, k, v, causal=form[-1], split=False).float()
    want = fa.flash_attention_plain(q, k, v, causal=form[-1]).float()
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    outside = (torch.abs(got - want) > atol + rtol * torch.abs(want)).float().mean().item()
    assert outside > 0.01


def test_executed_flops_count_the_tiles_each_body_visits():
    # prefill shape: blocks of 32 queries (G=4); block i visits i // 4 + 1 tiles
    # of 128 keys: 4 * (1 + ... + 8) = 144 per (batch, kv head)
    flops = fa.executed_flops(4, 1024, 1024, 32, 8, 128)
    assert flops == 4 * 8 * 144 * 128 * 128 * 6 * 128
    counted = roofline.attention_bound(batch=4, sq=1024, skv=1024, hq=32, hkv=8, d=128,
                                       hw=roofline.H100_SXM).flops
    assert 1.5 * counted < flops < 1.75 * counted
    assert fa.executed_flops(2, 300, 700, 16, 4, 64, causal=False) == (
        2 * 4 * 10 * 6 * 128 * 128 * 6 * 64)  # 1,200 rows in 10 blocks, 6 key tiles each
    assert fa.executed_flops(1, 64, 1088, 32, 8, 128, q_offset=1024) == (
        8 * 2 * 9 * 128 * 128 * 6 * 128)  # 256 rows, every block sees all 9 tiles
    assert fa.executed_flops(4, 1024, 1024, 32, 8, 128, dtype=torch.float32) == (
        4 * 8 * sum(i // 4 + 1 for i in range(64)) * 64 * 64 * 4 * 128)
    # MLA's prefill, G=1, D=192, Dv=128: block i of 128 rows visits i + 1
    # tiles of 128 keys, 1 + ... + 8 = 36; per pair 2D + 2 * 2Dv (PV twice)
    mla = fa.executed_flops(4, 1024, 1024, 128, 128, 192, dv=128)
    assert mla == 4 * 128 * 36 * 128 * 128 * (2 * 192 + 4 * 128)
    counted = roofline.attention_bound(batch=4, sq=1024, skv=1024, hq=128, hkv=128, d=192,
                                       dv=128, hw=roofline.H100_SXM)
    assert counted.bound_by == "bytes" and counted.bytes == 4 * 2 * 1024 * 128 * 2 * (192 + 128)
    assert 1.5 * counted.flops < mla < 1.75 * counted.flops


def test_cuda_checks_reject_bf16_strides_off_16_bytes():
    """TMA needs k and v strides of 16 bytes: multiples of 8 bf16 elements.
    The checks read shapes, strides and addresses only, so they run here."""
    fused = torch.zeros((1, 8, 4, 100), dtype=torch.bfloat16)  # a head stride of 100
    q, k, v = (fused[..., i * 32:(i + 1) * 32] for i in range(3))
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    with pytest.raises(ValueError, match="multiples of 8"):
        fa._check_cuda(q, k, v, 0)
    f32 = torch.zeros((1, 8, 4, 100))
    fa._check_cuda(*(f32[..., i * 32:(i + 1) * 32] for i in range(3)), 0)  # multiples of 4
    ok = torch.zeros((1, 8, 4, 96), dtype=torch.bfloat16)
    fa._check_cuda(*(ok[..., i * 32:(i + 1) * 32] for i in range(3)), 0)


def test_cuda_checks_hold_the_mla_pair_to_one_kv_head_a_query_head():
    """The bf16 kernel at (192, 128) is MLA's: G = 1 (every query head has
    its decompressed K and V).  GQA at that pair raises before a launch; the
    f32 body takes any G."""
    q = torch.zeros((1, 8, 4, 192), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 192), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="G = 1"):
        fa._check_cuda(q, k, v, 0)
    fa._check_cuda(q, torch.zeros((1, 8, 4, 192), dtype=torch.bfloat16),
                   torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16), 0)
    fa._check_cuda(q.float(), k.float(), v.float(), 0)


def test_split_kernel_checks_read_shapes_strides_and_addresses():
    """The split entry's card checks: 16-byte rows in every part (a q_nope
    sliced from MLA's 192-wide projection is read in place), one rope head
    or every head.  They read shapes, strides and addresses only, so they
    run here."""
    proj = torch.zeros((2, 8, 4, 192), dtype=torch.bfloat16)
    rope = torch.zeros((2, 8, 64), dtype=torch.bfloat16)[:, :, None]
    parts = (proj[..., :128], torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16),
             torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16), rope,
             torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16))
    assert fa._split_kernel(parts[0], parts[1], parts[4]) is False  # a CPU tensor
    fa._check_split(*parts)
    fa._check_split_cuda(parts, 0)
    odd = torch.zeros((2, 8, 4, 196), dtype=torch.bfloat16)[..., :128]  # rows 392 bytes apart
    with pytest.raises(ValueError, match="q_nope"):
        fa._check_split_cuda((odd, *parts[1:]), 0)
    with pytest.raises(ValueError, match="q_offset"):
        fa._check_split_cuda(parts, -1)


class _OtherDevice(torch.Tensor):
    """A tensor that reports ``device`` and holds no data: what the wrapper
    reads before it routes."""

    @staticmethod
    def __new__(cls, t: torch.Tensor, device: str):
        return torch.Tensor._make_wrapper_subclass(cls, t.shape, dtype=t.dtype,
                                                   device=torch.device(device))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor with no data")


def test_wrapper_rejects_other_devices_and_mismatched_operands():
    """A device but the card, the CPU and ``meta`` raises before any op;
    ``meta`` (the dry run's shapes without data) goes to the plain version
    and gives the output's shape."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 4, 2, 32, seed=7))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(_OtherDevice(t, "xpu") for t in (q, k, v)))
    meta = fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert meta.device.type == "meta" and meta.shape == q.shape
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
