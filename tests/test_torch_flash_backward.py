"""The flash backward's bf16 tensor-core body, checked on the CPU: its
arithmetic emulated in torch against the plain version, and its tiling,
shared memory and executed flops.

The kernel (``csrc/flash_attention.cu``, namespace ``tcb``) cannot run here,
so the emulation repeats what it rounds: bf16 operands whose products are
exact and summed in f32; the raw score scaled in f32 inside the exponent,
``P = 2^(S c - lse log2 e)`` with ``c = D^-1/2 log2 e``; P and dS each split
into two bf16 parts, ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, both
multiplied in; D^-1/2 applied to dK and dQ in f32; each output rounded once
to bf16.  It is held to the unchanged ``kernel_tolerance(bf16)``, scaled to
each gradient's largest magnitude, as the card tests hold the kernel.  The
card runs the kernel itself in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  The plain backward at a value head narrower than the
key head (MLA's shape) is held against ``jax.grad`` of the reference.
"""
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.core import roofline
from repro_torch.kernels import flash_attention as fa

BF16 = torch.bfloat16
LOG2E = math.log2(math.e)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _inputs(b, sq, skv, hq, hkv, d, seed, dv=None):
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv), (b, sq, hq, dv))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(BF16) for s in shapes]


def _parts(x, split):
    """x as the bf16 parts the kernel multiplies in (f32 values)."""
    hi = x.to(BF16).to(torch.float32)
    return (hi, (x - hi).to(BF16).to(torch.float32)) if split else (hi,)


def _tensor_core_bwd(q, k, v, out, dout, lse, *, causal, q_offset=0, split=True):
    """The bf16 body's arithmetic (see the module docstring) on whole
    (folded row, key) grids; the kernel's tiles only reorder f32 sums.
    ``split=False``: one bf16 rounding of P and dS instead."""
    b, sq, hq, d = q.shape
    skv, hkv, d_v = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    f32 = torch.float32
    scale = torch.tensor(d**-0.5, dtype=f32)
    c = scale * torch.tensor(LOG2E, dtype=f32)
    qf = q.to(f32).reshape(b, sq, hkv, g, d)
    dof = dout.to(f32).reshape(b, sq, hkv, g, d_v)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dout.to(f32) * out.to(f32)).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    lse2 = lse.to(f32).reshape(b, hkv, g, sq) * torch.tensor(LOG2E, dtype=f32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    p = torch.exp2(s * c - lse2[..., None])
    if causal:
        visible = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None] + q_offset
        p = torch.where(visible, p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = sum(torch.einsum("bhgqk,bqhgd->bkhd", part, dof) for part in _parts(p, split))
    dk = sum(torch.einsum("bhgqk,bqhgd->bkhd", part, qf) for part in _parts(ds, split)) * scale
    dq = sum(torch.einsum("bhgqk,bkhd->bqhgd", part, kf) for part in _parts(ds, split)) * scale
    return dq.reshape(b, sq, hq, d).to(BF16), dk.to(BF16), dv.to(BF16)


def _shares(got, want):
    """Each gradient's error as a share of its kernel_tolerance(bf16) limit."""
    atol, rtol = fa.kernel_tolerance(BF16)
    return [(g.float() - w.float()).abs().max().item()
            / (atol + rtol * w.float().abs().max().item()) for g, w in zip(got, want)]


BWD_ROUNDING_FORMS = [  # (batch, sq, skv, hq, hkv, d, causal, q_offset[, dv])
    (1, 256, 256, 8, 2, 128, True, 0),
    (1, 512, 512, 8, 2, 64, False, 0),
    (2, 300, 300, 16, 2, 32, True, 0),
    (1, 1024, 1024, 32, 8, 128, True, 0),  # the training shape at B=1
    (2, 64, 200, 8, 2, 64, True, 136),  # queries continuing a 136-token prefix
    (1, 256, 256, 4, 4, 192, True, 0, 128),  # MLA's (D, Dv) = (192, 128), G = 1
]


def _form_inputs(form):
    b, sq, skv, hq, hkv, d, causal, q_offset = form[:8]
    dv = form[8] if len(form) > 8 else None
    q, k, v, dout = _inputs(b, sq, skv, hq, hkv, d, seed=sum(form[:6]), dv=dv)
    kw = dict(causal=causal, q_offset=q_offset)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (q, k, v, out, dout, lse), kw


@pytest.mark.parametrize("form", BWD_ROUNDING_FORMS)
def test_split_p_and_ds_keep_the_kernel_tolerance(form):
    """The bf16 body's rounding (P and dS in two bf16 parts each) stays
    within ``kernel_tolerance(bf16)`` of the plain version, each gradient
    against its own largest magnitude, with more than half the limit to
    spare."""
    args, kw = _form_inputs(form)
    got = _tensor_core_bwd(*args, **kw)
    want = fa.flash_attention_bwd_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and g.shape == w.shape
    assert max(_shares(got, want)) < 0.5, _shares(got, want)


def test_one_bf16_rounding_leaves_under_a_tenth_of_the_tolerance():
    """Why P and dS are split: with one bf16 rounding of each, the queries
    continuing a 136-token prefix put dk within 10 % of its limit (0.91 of
    it here; on the card a form's dv reached 0.91), where the split leaves
    it under half."""
    args, kw = _form_inputs(BWD_ROUNDING_FORMS[4])
    want = fa.flash_attention_bwd_plain(*args, **kw)
    one = _shares(_tensor_core_bwd(*args, **kw, split=False), want)
    assert 0.9 < max(one) <= 1.0, one
    assert max(_shares(_tensor_core_bwd(*args, **kw), want)) < 0.5


def test_bwd_tiling_per_dtype():
    assert fa.bwd_tiling(BF16, 32) == {"dkdv": (64, 64, 4), "dq": (128, 128, 2)}
    # D=128 (flash_bwd_d128): both kinds of item on one ring of three stages
    assert fa.bwd_tiling(BF16) == {"dkdv": (64, 64, 3), "dq": (128, 128, 3)}
    assert fa.bwd_tiling(torch.float32) == {"dkdv": (64, 64, 1), "dq": (64, 64, 1)}
    assert fa.bwd_tiling(BF16)["dq"][:2] == fa.tiling(BF16)[:2]  # dQ reads K/V as the forward


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bwd_smem_fits_one_block_per_sm(dtype):
    """Each backward kernel's shared memory per block fits Hopper's 227 KB
    (232,448 bytes) at every head dim; at D=128 the bf16 body is one
    persistent kernel (``flash_bwd_d128``): 1 KB to align, two operand slots
    of 64 KB (a dK/dV item's K and V of 128 keys, or a dQ item's Q and dO of
    128 rows), three ring stages of 32 KB (a Q and a dO row tile of 64, or a
    K or a V tile of 128 keys) with a row tile's statistics each, a full and
    an empty barrier for each slot and stage, the slots' items: 232,032."""
    for d, dv in fa.BWD_HEAD_DIMS:
        dkdv, dq = fa.bwd_smem_bytes(d, dtype, dv)
        assert max(dkdv, dq) <= 232448
    if dtype == BF16:
        smem = 1024 + 2 * 65536 + 3 * (32768 + 512) + 16 * (2 + 3) + 16
        assert fa.bwd_smem_bytes(128, dtype) == (smem, smem) == (232032, 232032)
        assert fa.bwd_smem_bytes(32, dtype) < fa.bwd_smem_bytes(64, dtype)
    else:
        assert fa.bwd_smem_bytes(128, dtype) == (165888, 149248)  # f32 rows of D + 1


def test_bwd_executed_flops_count_the_tiles_each_body_visits():
    # training shape, G=4: key tile j of 64 starts at row tile 4j of 64 (64 - 4j
    # visited: 544 of 16 key tiles); dQ block i of 128 rows (32 queries)
    # visits i // 4 + 1 tiles of 128 keys: 4 * (1 + ... + 8) = 144
    # (bf16: dK/dV six products of 2D per pair, dQ four, P and dS split)
    flops = fa.bwd_executed_flops(2, 1024, 1024, 32, 8, 128)
    assert flops == 2 * 8 * (544 * 64 * 64 * 12 * 128 + 144 * 128 * 128 * 8 * 128)
    counted = roofline.attention_bwd_bound(batch=2, sq=1024, skv=1024, hq=32, hkv=8, d=128,
                                           hw=roofline.H100_SXM).flops
    assert 2.1 * counted < flops < 2.2 * counted  # 10 executed products for 5, and tile waste
    # f32: 64-row dQ blocks against 64-key tiles, 4 * (1 + ... + 16) = 544
    assert fa.bwd_executed_flops(2, 1024, 1024, 32, 8, 128, dtype=torch.float32) == (
        2 * 8 * (544 * 64 * 64 * 8 * 128 + 544 * 64 * 64 * 6 * 128))
    # non-causal, ragged: 1,200 rows (19 tiles of 64, 10 blocks of 128) and
    # 700 keys (11 tiles of 64, 6 of 128), every tile visited
    assert fa.bwd_executed_flops(2, 300, 700, 16, 4, 64, causal=False) == (
        2 * 4 * (11 * 19 * 64 * 64 * 12 * 64 + 10 * 6 * 128 * 128 * 8 * 64))
    # q_offset 136, Sq=64, G=4: keys 0..199 are seen from row 0 up to key 136,
    # then key tile 3 (192..199) from row 4 * 56; no key lies past every row
    assert fa.bwd_executed_flops(2, 64, 200, 8, 2, 64, q_offset=136) == (
        2 * 2 * ((3 * 4 + 4 - 224 // 64) * 64 * 64 * 12 * 64 + 2 * 2 * 128 * 128 * 8 * 64))
    # G=3: row tiles of 63 folded rows (21 queries), computed 64 wide; 231
    # rows in 4 tiles; key tile 1 is first seen at row 192, in tile 3
    assert fa.bwd_executed_flops(1, 77, 77, 12, 4, 128) == (
        1 * 4 * ((4 + 1) * 64 * 64 * 12 * 128 + 2 * 1 * 128 * 128 * 8 * 128))


def test_bwd_tiling_at_mla_heads():
    """At MLA's (192, 128) the bf16 dK/dV kernel (``flash_bwd_dkdv_mla``)
    holds one key tile of 64 a block, whose consumers split the products,
    with four row tiles in flight; the dQ kernel reads K/V tiles of 64
    keys; the f32 body's tiling does not depend on the head dims."""
    assert fa.bwd_tiling(BF16, 192, 128) == {"dkdv": (64, 64, 4), "dq": (128, 64, 2)}
    assert fa.bwd_tiling(BF16, 32, 32) == fa.bwd_tiling(BF16, 64)
    assert fa.bwd_tiling(BF16, 128, 128) == fa.bwd_tiling(BF16) == fa.BWD_TILING_D128
    assert fa.bwd_tiling(torch.float32, 192, 128) == fa.bwd_tiling(torch.float32)
    assert list(fa.BWD_HEAD_DIMS) == list(fa.HEAD_DIMS) and (192, 128) in fa.BWD_HEAD_DIMS


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bwd_smem_at_mla_heads_fits_one_block(dtype):
    """Shared memory at (192, 128), Q and K tiles 192 wide, V and dO 128:
    bf16 dK/dV 1 KB + K and V of one key tile (40 KB) + four stages of a
    64-row Q and dO tile with their statistics + the row tile's P^T in f32
    (16 KB) = 224,320 bytes (two key tiles with four stages: 248,896, past
    Hopper's 232,448); bf16 dQ 1 KB + Q and dO of 128 rows + two stages of
    64-key K and V tiles = 164,896 (128-key tiles: 246,816); f32 rows of D
    + 1 and Dv + 1: 198,656 and 182,016."""
    dkdv, dq = fa.bwd_smem_bytes(192, dtype, dv=128)
    assert max(dkdv, dq) <= 232448
    if dtype == BF16:
        assert (dkdv, dq) == (224320, 164896)
        assert dkdv == (1024 + 64 * 2 * (192 + 128) + 4 * (64 * 2 * (192 + 128) + 512 + 16)
                        + 64 * 64 * 4)
        assert 1024 + 2 * 64 * 2 * 320 + 4 * (64 * 2 * 320 + 528) == 248896 > 232448
        assert dq == 1024 + 128 * 2 * 320 + 2 * 64 * 2 * 320 + 32
        assert 1024 + 128 * 2 * 320 + 2 * 128 * 2 * 320 + 32 == 246816 > 232448
    else:
        assert (dkdv, dq) == (198656, 182016)
        assert dkdv == 4 * (64 * 193 * 2 + 64 * 129 * 2 + 2 * 64 * 65 + 2 * 64)
    assert fa.bwd_smem_bytes(128, dtype, dv=128) == fa.bwd_smem_bytes(128, dtype)


@pytest.mark.parametrize("rope_heads", [1, 4])
def test_split_p_and_ds_keep_the_kernel_tolerance_on_mla_parts(rope_heads):
    """The bf16 body's rounding on MLA's parts (``flash_attention_split_bwd``
    at (192, 128), G = 1): q and k as read from q_nope | q_rope and k_nope |
    k_rope, the rope part of one head (shared by every head, whose
    gradient is the heads' bf16 gradients summed) or of every head.  Each
    of the five gradients within half of ``kernel_tolerance(bf16)`` of the
    plain split backward, against its own largest magnitude."""
    rng = np.random.default_rng(192 + rope_heads)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(BF16)

    b, s, h = 1, 200, 4
    parts = [normal(b, s, h, 128), normal(b, s, h, 64), normal(b, s, h, 128),
             normal(b, s, rope_heads, 64), normal(b, s, h, 128)]
    dout = normal(b, s, h, 128)
    out, lse = fa._split_forward(*parts, causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                                 with_lse=True)
    want = fa.flash_attention_split_bwd(*parts, out, dout, lse)
    q, k = fa._joined(*parts[:4])
    dq, dk, dv = _tensor_core_bwd(q, k, parts[4], out, dout, lse, causal=True)
    got = (*fa._split_grads(dq, dk, 64, rope_heads), dv)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max(_shares(got, want)) < 0.5, _shares(got, want)


def test_bwd_executed_flops_at_mla_heads():
    """deepseek-v3's training shape (B=2, S=1,024, H=128, G=1, causal) at
    (192, 128): dK/dV key tile j of 64 visits row tiles j..15 (136 in all),
    each pair S^T (2D), dP^T (2Dv), dV and dK twice (bf16 parts); dQ block i
    of 128 rows visits 2i + 2 key tiles of 64 (72), each pair S (2D), dP
    (2Dv) and dQ twice.  2.18x the counted flops of five products."""
    flops = fa.bwd_executed_flops(2, 1024, 1024, 128, 128, 192, dv=128)
    kv_pair = 2 * 192 + 2 * 128 + 2 * (2 * 128 + 2 * 192)
    q_pair = 2 * 192 + 2 * 128 + 2 * 2 * 192
    assert flops == 2 * 128 * (136 * 64 * 64 * kv_pair + 72 * 128 * 64 * q_pair)
    bound = roofline.attention_bwd_bound(batch=2, sq=1024, skv=1024, hq=128, hkv=128, d=192,
                                         dv=128, hw=roofline.H100_SXM)
    assert bound.flops == 2 * 2 * 128 * (3 * 192 + 2 * 128) * (1024 * 1025 // 2)
    assert 2.1 * bound.flops < flops < 2.2 * bound.flops
    # each tensor once: q, k, dq, dk 192 wide, v, out, dout, dv 128, bf16; lse f32
    assert bound.bytes == 2 * 2 * (1024 * 128 * 2) * 2 * (192 + 128) + 4 * 2 * 128 * 1024
    # f32: 64-row dQ blocks against 64-key tiles, 1 + ... + 16 = 136 a head
    assert fa.bwd_executed_flops(2, 1024, 1024, 128, 128, 192, dtype=torch.float32, dv=128) == (
        2 * 128 * 136 * 64 * 64 * ((4 * 192 + 4 * 128) + (4 * 192 + 2 * 128)))
    assert fa.bwd_executed_flops(2, 1024, 1024, 32, 8, 128, dv=128) == fa.bwd_executed_flops(
        2, 1024, 1024, 32, 8, 128)


def test_bwd_executed_flops_skip_keys_no_row_sees_in_the_bf16_body():
    """Sq=10 queries (G=1) against 200 keys without an offset: key tiles
    from 64 on are seen by no row.  The bf16 body visits only key tile 0;
    the f32 body starts each key tile at its first row's tile, here past
    the end for tiles 1..3 (first row 64 and more: none visited)."""
    bf16 = fa.bwd_executed_flops(1, 10, 200, 1, 1, 64)
    assert bf16 == 1 * 64 * 64 * 12 * 64 + 1 * 128 * 128 * 8 * 64
    assert fa.bwd_executed_flops(1, 10, 200, 1, 1, 64, dtype=torch.float32) == (
        1 * 64 * 64 * 8 * 64 + 1 * 64 * 64 * 6 * 64)


def test_causal_key_tile_pairs_carry_equal_work():
    """The bf16 dK/dV kernel pairs key tile j with n - 1 - j in one block:
    under the causal mask at the training shape each pair multiplies 68 row
    tiles, where single key tiles range from 64 to 4."""
    rows, g, n = 1024 * 4, 4, 16
    visited = [rows // 64 - (64 * j * g) // 64 for j in range(n)]
    assert (max(visited), min(visited)) == (64, 4)
    assert {visited[j] + visited[n - 1 - j] for j in range(n // 2)} == {68}


def test_rows_aligned_decides_which_dout_is_copied():
    """The bf16 body reads dout's rows by 16-byte copies: a dout whose
    strides or base are off 16 bytes is copied before the launch; a
    contiguous one or a 16-byte aligned slice is read in place."""
    wide = torch.zeros((2, 8, 4, 256), dtype=BF16)
    assert fa._rows_aligned(wide[..., :128])
    assert not fa._rows_aligned(wide[..., 1:129])  # base off 16 bytes
    assert not fa._rows_aligned(torch.zeros((2, 8, 4, 100), dtype=BF16)[..., :64])
    assert not fa._rows_aligned(wide.transpose(-1, -2)[..., :4])  # head dim not contiguous


def test_smoke_counts_hgmma_per_function():
    """``chip_smoke.py`` splits a ``cuobjdump -sass`` listing at its
    ``Function :`` headers, so each bf16 backward kernel is checked for
    HGMMA on its own and the forward's cannot stand in for it."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN3tcb17flash_bwd_dkdv_tcILi128ELb1EEEv",
        "        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0110*/                   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        "\t\tFunction : _ZN3bwd14flash_bwd_dkdvIfLi128ELb1EEEv",
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;",
        "\t\tFunction : _ZN2tc18flash_attention_tcILi128ELb1EEEv",
        "        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;",
    ])
    counts = smoke._sass_per_function(listing, "HGMMA")
    assert counts == {"_ZN3tcb17flash_bwd_dkdv_tcILi128ELb1EEEv": 2,
                      "_ZN3bwd14flash_bwd_dkdvIfLi128ELb1EEEv": 0,
                      "_ZN2tc18flash_attention_tcILi128ELb1EEEv": 1}
    assert [n for n in counts if smoke.BWD_TC_KERNELS[0] in n] == [
        "_ZN3tcb17flash_bwd_dkdv_tcILi128ELb1EEEv"]


@pytest.mark.parametrize("chunks", [(8, 8), (5, 7)], ids=["8x8", "ragged"])
def test_gradients_at_a_narrower_value_head_equal_jax_grad(chunks):
    """``flash_attention`` differentiated on the CPU at D=24, Dv=16 (causal,
    G=2): dq, dk and dv against ``jax.grad`` of the reference's chunked
    ``models/attention.py`` ``flash_attention`` on the same numpy inputs and
    the same cotangent (f32; sums in another order)."""
    rng = np.random.default_rng(24)
    q = rng.standard_normal((1, 20, 4, 24), dtype=np.float32)
    k = rng.standard_normal((1, 20, 2, 24), dtype=np.float32)
    v = rng.standard_normal((1, 20, 2, 16), dtype=np.float32)
    g = rng.standard_normal((1, 20, 4, 16), dtype=np.float32)
    q_chunk, kv_chunk = chunks
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    assert out.shape == (1, 20, 4, 16)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))

    def loss(q, k, v):
        o = jattention.flash_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return jnp.sum(o * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


# -- bf16 at D = Dv = 64: one persistent kernel (flash_bwd_d64) over both kinds of item --

def test_bwd_tiling_smem_and_flops_at_d64():
    """At D = Dv = 64 one kernel holds both roles with the old kernels'
    tiling (row tiles of 64 through four stages; K/V tiles of 128 keys
    through two), in 199,824 bytes: 1 KB to align, two operand slots of 32
    KB (a dK/dV item's K and V of two key tiles, or a dQ item's Q and dO of
    128 rows), four stages of a Q and a dO row tile with their statistics,
    two stages of a K and a V tile, a full and an empty barrier for each
    slot and stage, and the items the slots hold.  Its flops are the old
    kernels' where G divides 128."""
    assert fa.bwd_tiling(BF16, 64) == {"dkdv": (64, 64, 4), "dq": (128, 128, 2)}
    smem = 1024 + 2 * 32768 + 4 * (2 * 64 * 128 + 512) + 2 * 2 * 128 * 128 + 8 * 16 + 16
    assert fa.bwd_smem_bytes(64, BF16) == (smem, smem) == (199824, 199824)
    assert smem <= 232448
    # granite-moe's training shape: key tile j (of 16) walks row tiles 2j..31;
    # dQ tile i of 128 folded rows (64 queries) key tiles i // 2 + 1
    assert fa.bwd_executed_flops(2, 1024, 1024, 16, 8, 64) == 2 * 8 * (
        272 * 64 * 64 * 12 * 64 + 72 * 128 * 128 * 8 * 64)


def test_bwd_tiling_smem_and_flops_keep_the_other_head_dims():
    """D=32 and MLA's (192, 128) keep their kernels and numbers; D=64 and
    D=128 take the persistent kernels' whole-group dQ tiles: at G=3 an item
    holds 126 folded rows, so 255 rows take three where tiles of 128 took
    two."""
    assert fa.bwd_tiling(BF16, 32) == {"dkdv": (64, 64, 4), "dq": (128, 128, 2)}
    assert fa.bwd_smem_bytes(32, BF16) == (52288, 50208)
    assert fa.bwd_smem_bytes(128, BF16) == (232032, 232032)
    assert fa.bwd_smem_bytes(192, BF16, dv=128) == (224320, 164896)
    # 85 queries of G=3 (255 folded rows), causal, one key tile of 128 each
    kv = 85 * 3 // 63 + 1  # row tiles of 63 folded rows: 5, all seen by key tile 0 (of 2)
    assert fa.bwd_executed_flops(1, 85, 85, 12, 4, 64) == 4 * (
        (kv + (kv - 64 * 3 // 63)) * 64 * 64 * 12 * 64 + 3 * 128 * 128 * 8 * 64)
    assert fa.bwd_executed_flops(1, 85, 85, 12, 4, 128) == 4 * (
        (kv + (kv - 64 * 3 // 63)) * 64 * 64 * 12 * 128 + 3 * 128 * 128 * 8 * 128)


def _delta_lanes(d, o):
    """flash_bwd_delta<bf16, Dv, true>'s sum of a row (f32): lane c of 32
    sums columns c, c + 32, ... by a chain of fma from 0 (a bf16 product is
    exact in f32, so each fma is one rounding of the f32 sum), then the xor
    tree over lanes: level k adds the value of lane c ^ k to lane c's; lane
    0's is stored."""
    v = []
    for c in range(32):
        acc = d[:, c] * o[:, c]
        for col in range(c + 32, d.shape[1], 32):
            acc = acc + d[:, col] * o[:, col]
        v.append(acc)
    for off in (16, 8, 4, 2, 1):
        v = [v[c] + v[c ^ off] for c in range(32)]
    return v[0]


def _delta_threads(d, o):
    """flash_bwd_delta_vec<Dv>'s: thread j of 4 holds columns 32i + 8j + e
    (i < Dv / 32) in register e, chained over i; level 16 adds thread j +
    2's registers to thread j's, level 8 thread 1's to thread 0's, levels 4,
    2, 1 add thread 0's registers e + 4, e + 2, e + 1."""
    regs = []
    for j in range(4):
        row = []
        for e in range(8):
            acc = d[:, 8 * j + e] * o[:, 8 * j + e]
            for col in range(32 + 8 * j + e, d.shape[1], 32):
                acc = acc + d[:, col] * o[:, col]
            row.append(acc)
        regs.append(row)
    regs = [[regs[j][e] + regs[j + 2][e] for e in range(8)] for j in range(2)]
    x = [regs[0][e] + regs[1][e] for e in range(8)]
    x = [x[e] + x[e + 4] for e in range(4)]
    x = [x[e] + x[e + 2] for e in range(2)]
    return x[0] + x[1]


def test_d64_delta_pass_adds_as_the_lanes_did():
    """The D=64 delta pass reads a row by four threads of 16 bytes where
    flash_bwd_delta read it by 32 lanes of 2 bytes; it adds the same values
    in the same pairs, so delta is the same f32 bits (hence dq and dk)."""
    rng = np.random.default_rng(64)
    d, o = (torch.from_numpy(rng.standard_normal((4096, 64), dtype=np.float32)).to(BF16).float()
            for _ in range(2))
    want, got = _delta_lanes(d, o), _delta_threads(d, o)
    assert want.dtype == got.dtype == torch.float32
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))
    # a tree of other pairs gives other bits for some rows
    other = torch.stack([d[:, c] * o[:, c] for c in range(64)], 1).sum(1)
    assert not torch.equal(other.view(torch.int32), want.view(torch.int32))


def test_d128_delta_pass_adds_as_the_lanes_did():
    """The D=128 delta pass (flash_bwd_delta_vec<128>, before flash_bwd_d128)
    reads a row by four threads of 16 bytes at four column offsets where
    flash_bwd_delta read it by 32 lanes of 2 bytes: the same chains of four
    products and the same tree, so delta is the same f32 bits (hence dq and
    dk are those of the separate dK/dV and dQ kernels)."""
    rng = np.random.default_rng(128)
    d, o = (torch.from_numpy(rng.standard_normal((4096, 128), dtype=np.float32)).to(BF16).float()
            for _ in range(2))
    want, got = _delta_lanes(d, o), _delta_threads(d, o)
    assert want.dtype == got.dtype == torch.float32
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))
    # the chains in another order give other bits for some rows
    other = _delta_lanes(d[:, list(range(127, -1, -1))], o[:, list(range(127, -1, -1))])
    assert not torch.equal(other.view(torch.int32), want.view(torch.int32))


def test_bwd_items_at_d128_hold_whole_query_groups():
    """flash_bwd_d128 walks flash_bwd_d64's items: dK/dV pairs of key tiles
    of 64 over row tiles of G * (64 // G) folded rows, and dQ tiles of G *
    (128 // G) folded rows against key tiles of 128.  At granite-34b's G=48
    a row tile holds 48 rows (one query) and a dQ tile 96 (two); at
    internvl2-26b's G=6, 60 and 126."""
    for g, q_rows in ((48, 96), (6, 126), (4, 128)):
        assert fa.tile_rows(BF16, 128, g) == q_rows
    # 128 queries of 48 heads, causal: key tile 0 of 64 walks all 128 row
    # tiles, key tile 1 the 64 from query 64 on; 64 dQ tiles of 96 rows see
    # the one key tile of 128
    assert fa.bwd_executed_flops(1, 128, 128, 48, 1, 128) == (
        (128 + 64) * 64 * 64 * 12 * 128 + 64 * 128 * 128 * 8 * 128)
