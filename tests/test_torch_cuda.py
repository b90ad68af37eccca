"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA device (marker ``cuda``) and skip without one.
The file imports torch and the port only, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.core.su3.plan import verify_tolerance
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, su3_matmul
from repro_torch.models import common, mamba2, mla, registry, zamba
from repro_torch.serve.engine import ServeConfig, ServeEngine

S = 256


def _su3_planar(n_sites: int, seed: int) -> np.ndarray:
    """Random SU(3) links as planar (2, 36, n_sites) f32."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)
    return np.stack([q.real, q.imag]).transpose(0, 2, 3, 4, 1).reshape(2, 36, n_sites)


def _inputs(dtype: str, compressed: bool, seed: int):
    a = _su3_planar(S, seed)
    if compressed:
        a = a[:, list(COMP_ROW_INDICES)]
    b = _su3_planar(1, seed + 1)[..., 0]
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(tdt),
            torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(tdt))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


FORMS = [  # (storage dtype, accum dtype, two-row)
    ("float32", None, False),
    ("bfloat16", "float32", False),
    ("bfloat16", None, False),
    ("float32", None, True),
    ("bfloat16", "float32", True),
    ("bfloat16", None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
@pytest.mark.parametrize("aosoa", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, accum, compressed, aosoa):
    ta, tb = _inputs(dtype, compressed, seed=8)
    if aosoa:
        ta = torch.movedim(ta.reshape(2, ta.shape[1], S // 64, 64), 2, 0).contiguous()
    for k in (1, 8, 13):
        want = ops.su3_mult_planar(ta, tb, tile=64, k_iters=k, accum_dtype=accum,
                                   compressed=compressed)
        before = su3_matmul.LAUNCHES.count
        got = ops.su3_mult_planar(ta.to(cuda_device), tb.to(cuda_device), tile=64, k_iters=k,
                                  accum_dtype=accum, compressed=compressed)
        torch.cuda.synchronize()
        assert su3_matmul.LAUNCHES.count == before + 1
        err = torch.max(torch.abs(got.cpu().float() - want.float())).item()
        assert err <= verify_tolerance(dtype, accum or "", compressed), (k, err)


@pytest.mark.cuda
def test_cuda_chain_bitwise_equals_single_launches_and_in_place(cuda_device):
    ta, tb = _inputs("float32", False, seed=9)
    a, b = ta.to(cuda_device), tb.to(cuda_device)
    chained = ops.su3_mult_planar(a, b, tile=S, k_iters=13)
    x = a
    for _ in range(13):
        x = ops.su3_mult_planar(x, b, tile=S)
    assert torch.equal(chained, x)
    y = a.clone()
    assert ops.su3_mult_planar(y, b, tile=S, k_iters=13, alias=True) is y
    assert torch.equal(y, chained)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mismatched_operands(cuda_device):
    ta, tb = _inputs("float32", False, seed=10)
    a = ta.to(cuda_device)
    with pytest.raises(ValueError, match="match a's device and dtype"):
        ops.su3_mult_planar(a, tb, tile=S)
    with pytest.raises(ValueError, match="contiguous"):
        ops.su3_mult_planar(a.transpose(1, 2).contiguous().transpose(1, 2),
                            tb.to(cuda_device), tile=S)


# -- the slot-batched megakernel and the multiply's batch axis -------------------

SLOT_K = [0, 1, 3, 4, 9]  # dead, single, deep, max_k, above max_k (clamped)
MAX_K = 4


def _table(dtype: str, compressed: bool, aosoa: bool, seed: int):
    """A slot table of len(SLOT_K) random lattices and per-slot B, on the CPU."""
    pairs = [_inputs(dtype, compressed, seed + 2 * s) for s in range(len(SLOT_K))]
    a = torch.stack([_to_aosoa(x, 64) if aosoa else x for x, _ in pairs]).contiguous()
    return a, torch.stack([y for _, y in pairs]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
@pytest.mark.parametrize("aosoa", [False, True])
def test_cuda_megakernel_matches_plain_version(cuda_device, dtype, accum, compressed, aosoa):
    a, b = _table(dtype, compressed, aosoa, seed=20)
    ks = torch.tensor(SLOT_K, dtype=torch.int32)
    kw = {"tile": 64, "max_k": MAX_K, "accum_dtype": accum, "compressed": compressed}
    want = ops.su3_mult_planar_batched(a, b, ks, **kw)
    before = su3_matmul.MEGA_LAUNCHES.count
    ad, bd, kd = a.to(cuda_device), b.to(cuda_device), ks.to(cuda_device)
    got = ops.su3_mult_planar_batched(ad, bd, kd, **kw)
    aliased = ad.clone()
    assert ops.su3_mult_planar_batched(aliased, bd, kd, alias=True, **kw) is aliased
    torch.cuda.synchronize()
    assert su3_matmul.MEGA_LAUNCHES.count == before + 2
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)  # bitwise in every form
    assert torch.equal(aliased, got)  # in place equals out of place
    assert torch.equal(got[0].cpu(), a[0])  # depth 0 passes through


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,accum", [("float32", None), ("bfloat16", None)])
def test_cuda_megakernel_slot_chain_equals_single_launches(cuda_device, dtype, accum):
    a, b = _table(dtype, False, False, seed=30)
    a, b = a.to(cuda_device), b.to(cuda_device)
    ks = torch.tensor(SLOT_K, dtype=torch.int32, device=cuda_device)
    got = ops.su3_mult_planar_batched(a, b, ks, tile=64, max_k=MAX_K, accum_dtype=accum)
    for s, k in enumerate(SLOT_K):
        x = a[s]
        for _ in range(min(k, MAX_K)):
            x = ops.su3_mult_planar(x, b[s], tile=64, accum_dtype=accum)
        assert torch.equal(got[s], x), s


@pytest.mark.cuda
@pytest.mark.parametrize("aosoa", [False, True])
def test_cuda_batch_axis_equals_per_lattice_launches(cuda_device, aosoa):
    a, b = _table("float32", False, aosoa, seed=40)
    a, b = a.to(cuda_device), b.to(cuda_device)
    before = su3_matmul.LAUNCHES.count
    got = ops.su3_mult_planar(a, b, tile=64, k_iters=3)
    assert su3_matmul.LAUNCHES.count == before + 1  # one launch for the batch
    for s in range(a.shape[0]):
        assert torch.equal(got[s], ops.su3_mult_planar(a[s], b[s], tile=64, k_iters=3))


@pytest.mark.cuda
def test_cuda_megakernel_rejects_bad_operands(cuda_device):
    a, b = (t.to(cuda_device) for t in _table("float32", False, False, seed=50))
    ks = torch.tensor(SLOT_K, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="slot_k must be int32"):
        ops.su3_mult_planar_batched(a, b, ks.long(), tile=64)
    with pytest.raises(ValueError, match="slot_k must be int32"):
        ops.su3_mult_planar_batched(a, b, ks.cpu(), tile=64)
    with pytest.raises(ValueError, match="match a's device and dtype"):
        ops.su3_mult_planar_batched(a, b.cpu(), ks, tile=64)


# -- the stencil and the fused CG body --------------------------------------------


def _stencil_inputs(dtype: str, compressed: bool, seed: int):
    """Random SU(3) links (2, rows, S) and random neighbour blocks and
    vectors, in the storage dtype, on the CPU."""
    u, _ = _inputs(dtype, compressed, seed)
    rng = np.random.default_rng(seed + 100)
    tdt = getattr(torch, dtype)

    def vec(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)

    return u, vec(8, 2, 3, S), vec(8, 2, 3, S), vec(2, 3, S), vec(2, 3, S)


def _to_aosoa(u: torch.Tensor, lane: int) -> torch.Tensor:
    return torch.movedim(u.reshape(2, u.shape[1], S // lane, lane), 2, 0).contiguous()


def _same(got: torch.Tensor, want: torch.Tensor, dtype: str, accum, compressed) -> None:
    got = got.cpu()
    if dtype == "float32":  # bitwise, -0.0 against +0.0 included
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        err = torch.max(torch.abs(got.float() - want.float())).item()
        assert err <= verify_tolerance(dtype, accum or "", compressed), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
@pytest.mark.parametrize("aosoa", [False, True])
def test_cuda_stencil_and_cg_kernels_match_plain_versions(cuda_device, dtype, accum, compressed,
                                                          aosoa):
    from repro_torch.kernels import su3_stencil

    u, v, rn, r, p = _stencil_inputs(dtype, compressed, seed=11)
    coefs = torch.tensor([[0.37, 16.0]], dtype=torch.float32)
    kw = {"tile": 64, "accum_dtype": accum, "compressed": compressed}
    want_s = ops.su3_stencil_planar(u, v, **kw)
    want_p, want_cg = ops.su3_cg_fused_planar(u, v, rn, r, p, coefs, **kw)
    ud = (_to_aosoa(u, 64) if aosoa else u).to(cuda_device)
    dev = [t.to(cuda_device) for t in (v, rn, r, p, coefs)]
    before = (su3_stencil.STENCIL_LAUNCHES.count, su3_stencil.CG_LAUNCHES.count)
    got_s = ops.su3_stencil_planar(ud, dev[0], **kw)
    got_p, got_cg = ops.su3_cg_fused_planar(ud, *dev, **kw)
    torch.cuda.synchronize()
    assert (su3_stencil.STENCIL_LAUNCHES.count, su3_stencil.CG_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    for got, want in ((got_s, want_s), (got_p, want_p), (got_cg, want_cg)):
        assert got.dtype == want.dtype and tuple(got.shape) == (2, 3, S)
        _same(got, want, dtype, accum, compressed)


@pytest.mark.cuda
def test_cuda_stencil_site_subset_equals_full_pass(cuda_device):
    u, v, _, _, _ = _stencil_inputs("float32", False, seed=12)
    u, v = u.to(cuda_device), v.to(cuda_device)
    full = ops.su3_stencil_planar(u, v, tile=64)
    idx = torch.from_numpy(np.random.default_rng(3).permutation(S)[:128]).to(cuda_device)
    sub = ops.su3_stencil_planar(u[:, :, idx].contiguous(), v[..., idx].contiguous(), tile=64)
    assert torch.equal(sub.view(torch.int32), full[:, :, idx].view(torch.int32))


@pytest.mark.cuda
def test_cuda_stencil_wrappers_reject_bad_operands(cuda_device):
    u, v, rn, r, p = (t.to(cuda_device) for t in _stencil_inputs("float32", False, seed=13))
    with pytest.raises(ValueError, match="match u's device and dtype"):
        ops.su3_stencil_planar(u, v.cpu(), tile=64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.su3_stencil_planar(u, v.transpose(2, 3).contiguous().transpose(2, 3), tile=64)
    with pytest.raises(ValueError, match="coefs"):
        ops.su3_cg_fused_planar(u, v, rn, r, p, torch.zeros(1, 2), tile=64)


# -- the multi-slab schedules ------------------------------------------------------


def _slab_plans(cuda_device, hosts: int, L: int = 16, **fields):
    from repro_torch.core.su3.plan import EngineConfig, build_plan
    from repro_torch.launch.mesh import MeshSpec

    cfg = EngineConfig(L=L, tile=128, **fields)
    return build_plan(cfg, cuda_device), build_plan(cfg, MeshSpec(hosts=hosts).resolve(cuda_device))


def _slab_field(plan, seed: int):
    rng = np.random.default_rng(seed)
    n = plan.cfg.shape.n_sites
    u = _su3_planar(n, seed)  # (2, 36, n)
    u_c = torch.complex(*torch.from_numpy(u.astype(np.float32))).T.reshape(n, 4, 3, 3)
    v = torch.from_numpy((rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3)))
                         .astype(np.complex64))
    return plan.pack_gauge(u_c), plan.pack_rhs(v)


def _recording(monkeypatch, name: str, sink: list, u_phys: torch.Tensor):
    """Record the inputs of every launch of kernel ``name`` on links other
    than the lattice's own (the boundary and ring passes), then launch."""
    from repro_torch.kernels import su3_stencil

    orig = getattr(su3_stencil, name)

    def rec(*args, **kw):
        if args[0].data_ptr() != u_phys.data_ptr():
            sink.append(([a.clone() for a in args], dict(kw)))
        return orig(*args, **kw)

    monkeypatch.setattr(su3_stencil, name, rec)


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 4])
def test_cuda_multislab_stencil_chain_equals_serial(cuda_device, hosts):
    """Twenty chained overlapped steps (each one's output the next one's
    input) equal the serial chain bit for bit: the side-stream exchange
    never reads a field before the main stream made it, and never refills
    the ghost buffers while a boundary pass still reads them."""
    one, many = _slab_plans(cuda_device, hosts)
    u, v = _slab_field(many, 5)
    serial, ovl, ovl2 = one.stencil_step(), many.stencil_step(), many.stencil_step(depth=2)
    a = b = c = v
    for _ in range(20):
        a, b = serial(u, a), ovl(u, b)
    for _ in range(10):
        c = ovl2(u, c)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 4])
def test_cuda_boundary_and_ring_shapes_match_plain(cuda_device, monkeypatch, hosts):
    from repro_torch.kernels import su3_stencil

    _one, many = _slab_plans(cuda_device, hosts)
    u, v = _slab_field(many, 6)
    st, cg = [], []
    _recording(monkeypatch, "su3_stencil_planar", st, u)
    _recording(monkeypatch, "su3_cg_fused_planar", cg, u)
    many.stencil_step(depth=2)(u, v)
    many.cg_iterate(u, many.cg_state_init(v))
    torch.cuda.synchronize()
    monkeypatch.undo()
    b = 2 * 16**3 * hosts  # boundary sites of every slab
    assert sorted(args[0].shape[-1] for args, _ in st) == [b, b, 2 * b]
    assert [args[0].shape[-1] for args, _ in cg] == [b]
    for args, kw in st:
        got = su3_stencil.su3_stencil_planar(*args, **kw).cpu()
        want = su3_stencil.su3_stencil_planar_plain(*(a.cpu() for a in args))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for args, kw in cg:
        got = su3_stencil.su3_cg_fused_planar(*args, **kw)
        want = su3_stencil.su3_cg_fused_planar_plain(*(a.cpu() for a in args))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 4])
def test_cuda_overlapped_cg_equals_one_slab(cuda_device, hosts):
    from repro_torch.core.autotune import _cg_measure_problem

    one, many = _slab_plans(cuda_device, hosts)
    u_np, b_np = _cg_measure_problem(16)
    r1 = one.cg_solve(one.pack_gauge(u_np), one.pack_rhs(b_np))
    r2 = many.cg_solve(many.pack_gauge(u_np), many.pack_rhs(b_np), fused=True, overlap=True)
    r3 = many.cg_solve(many.pack_gauge(u_np), many.pack_rhs(b_np), fused=False, overlap=True)
    assert r1.converged and r2.iterations == r1.iterations == r3.iterations
    assert r2.residuals == r1.residuals == r3.residuals
    assert torch.equal(r2.x_p.view(torch.int32), r1.x_p.view(torch.int32))
    assert torch.equal(r3.x_p.view(torch.int32), r1.x_p.view(torch.int32))


# -- the prefill attention kernel ------------------------------------------------

FLASH_SHAPES = [  # (batch, sq, skv, hq, hkv, d, causal, q_offset)
    (2, 128, 128, 4, 4, 128, True, 0),  # G=1
    (2, 128, 128, 8, 2, 64, True, 0),  # G=4
    (1, 96, 96, 8, 1, 32, True, 0),  # G=8
    (1, 1000, 1000, 32, 8, 128, True, 0),  # a ragged length at the full widths
    (2, 77, 200, 4, 2, 64, False, 0),  # Sq != Skv, non-causal
    (1, 40, 104, 4, 1, 128, True, 64),  # queries that continue a 64-token prefix
    (2, 64, 64, 4, 2, 32, False, 0),  # non-causal, square
    (4, 1024, 1024, 16, 8, 64, True, 0),  # granite-moe-1b's prefill: D=64, G=2
    (4, 1024, 1024, 32, 32, 64, True, 0),  # zamba2-1.2b's shared-block prefill: D=64, G=1
    (4, 1500, 1500, 6, 6, 64, False, 0),  # whisper-tiny's encoder: 1,500 = 23 x 64 + 28
    (4, 16, 1500, 6, 6, 64, False, 0),  # whisper-tiny's cross-attention in serving's prefill
    (4, 16, 16, 6, 6, 64, True, 0),  # whisper-tiny's decoder self-attention in serving's prefill
    (2, 448, 1500, 6, 6, 64, False, 0),  # whisper-tiny's cross-attention in training
    (2, 448, 448, 6, 6, 64, True, 0),  # whisper-tiny's decoder self-attention in training
]


def _qkv(shape, dtype, seed):
    b, sq, skv, hq, hkv, d = shape[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain_version(cuda_device, shape, dtype):
    *_, causal, q_offset = shape
    q, k, v = (t.to(cuda_device) for t in _qkv(shape, dtype, seed=50))
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_chunk=64, kv_chunk=128,
                                    q_offset=q_offset)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = fa.kernel_tolerance(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_heads(cuda_device):
    """q, k, v sliced out of one fused (B, S, H, 3, D) projection."""
    gen = torch.Generator(device=cuda_device).manual_seed(53)
    fused = torch.randn((2, 80, 4, 3, 64), generator=gen, device=cuda_device)
    q, k, v = fused.unbind(3)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    got = fa.flash_attention(q, k, v)
    atol, rtol = fa.kernel_tolerance(torch.float32)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_bf16_projection(cuda_device):
    """bf16 q, k, v sliced out of one fused (B, S, (Hq + 2 Hkv) D) projection,
    as a fused QKV matmul leaves them: the tensor-core body's TMA reads k and
    v through those strides."""
    b, s, hq, hkv, d = 2, 200, 8, 2, 128
    gen = torch.Generator(device=cuda_device).manual_seed(54)
    fused = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen, device=cuda_device)
    fused = fused.to(torch.bfloat16)
    q = fused[..., :hq * d].unflatten(-1, (hq, d))
    k = fused[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d))
    v = fused[..., (hq + hkv) * d:].unflatten(-1, (hkv, d))
    assert not k.is_contiguous()
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    got = fa.flash_attention(q, k, v)
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv((1, 16, 16, 4, 2, 64), torch.float32, seed=51)
    with pytest.raises(ValueError, match="lie on"):
        fa.flash_attention(q.to(cuda_device), k, v.to(cuda_device))
    q96, k96, v96 = (t.to(cuda_device) for t in _qkv((1, 16, 16, 4, 2, 96), torch.float32, 52))
    with pytest.raises(ValueError, match="built for D"):
        fa.flash_attention(q96, k96, v96)
    with pytest.raises(NotImplementedError, match="MLA"):
        fa.flash_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device)[..., :32])
    # (192, 128) is MLA's pair; other Dv != D pairs, and D = 192 alone, are not built
    q192, k192 = (t.to(cuda_device) for t in _qkv((1, 16, 16, 4, 4, 192), torch.float32, 55)[:2])
    v192 = k192.clone()
    with pytest.raises(NotImplementedError, match="MLA"):
        fa.flash_attention(q192, k192, v192[..., :64].contiguous())
    with pytest.raises(ValueError, match="built for"):
        fa.flash_attention(q192, k192, v192)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(*(t.to(cuda_device, torch.float16) for t in (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,threads", [(torch.bfloat16, 384), (torch.float32, 256)])
def test_cuda_flash_attention_shared_memory_budget(cuda_device, dtype, threads):
    """Each body's real budget at every (D, Dv) it is built for: within 227
    KB a block, no spills, one block per SM or more (the bf16 body holds
    one: 230,512 bytes at D=128, one Q, three K and three V stages, and
    three warpgroups; 214,096 at MLA's (192, 128), two K and two V stages;
    132,224 at D=64, two Q, three K and three V stages), and the tiling
    the Python side assumes (kernel_budget raises otherwise)."""
    for d, dv in fa.HEAD_DIMS:
        for causal in (True, False):
            budget = fa.kernel_budget(dtype, d, causal=causal, dv=dv)
            assert budget["shared_bytes"] == fa.smem_bytes(d, dtype, dv) <= 232448
            assert budget["threads_per_block"] == threads
            assert budget["local_bytes"] == 0 and budget["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "minitron-8b", "granite-34b",
                                  "granite-moe-1b-a400m"])
def test_cuda_reduced_prefill_launches_once_per_layer(cuda_device, arch):
    cfg = get_config(arch).reduced()
    model = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=32), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=32), device=cuda_device)
    before = fa.LAUNCHES.count
    toks = card.generate(prompts, 6)
    assert fa.LAUNCHES.count - before == cfg.n_layers  # prefill only; decode is plain
    batch = {"tokens": torch.from_numpy(prompts)}
    want, _ = cpu.prefill(batch, cpu.init_state(2))
    got, _ = card.prefill({"tokens": batch["tokens"].to(cuda_device)}, card.init_state(2))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert toks.shape == (2, 26)


MLA_SHAPES = [  # (batch, sq, skv, heads, causal, q_offset): D = 192, Dv = 128, G = 1
    (2, 256, 256, 8, True, 0),
    (1, 333, 333, 4, True, 0),  # ragged
    (1, 100, 300, 4, False, 0),  # Sq != Skv, non-causal
    (1, 72, 200, 4, True, 128),  # queries that continue a 128-token prefix
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MLA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_at_mla_heads_matches_plain_version(cuda_device, shape, dtype):
    """The (D, Dv) = (192, 128) instantiation of each body against the plain
    version, one launch, out (B, Sq, H, 128)."""
    b, sq, skv, h, causal, q_offset = shape
    rng = np.random.default_rng(sum(shape[:4]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device, dtype)
               for s in ((b, sq, h, 192), (b, skv, h, 192), (b, skv, h, 128)))
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_chunk=64, kv_chunk=128,
                                    q_offset=q_offset)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, h, 128)
    atol, rtol = fa.kernel_tolerance(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _split_parts(shape, rope_heads, dtype, device, seed):
    """MLA's parts on the card: q_nope a view of a 192-wide projection,
    q_rope, k_nope, k_rope of rope_heads heads, v."""
    b, sq, skv, h = shape[:4]
    rng = np.random.default_rng(seed)

    def normal(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)

    return [normal(b, sq, h, 192)[..., :128], normal(b, sq, h, 64), normal(b, skv, h, 128),
            normal(b, skv, rope_heads, 64), normal(b, skv, h, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MLA_SHAPES)
@pytest.mark.parametrize("rope_heads", ["one", "every"])
def test_cuda_split_entry_at_mla_heads_matches_plain_version(cuda_device, shape, rope_heads):
    """``flash_attention_split`` (bf16, the kernel on the parts in place)
    against the plain version on the concatenated q and k: forward in one
    launch within kernel_tolerance; then through autograd (one forward and
    one backward launch), the five gradients within kernel_tolerance of
    each one's largest magnitude, against the plain backward split the same
    way, and the same bits twice."""
    b, sq, skv, h, causal, q_offset = shape
    hr = 1 if rope_heads == "one" else h
    dt = torch.bfloat16
    parts = _split_parts(shape, hr, dt, cuda_device, seed=sum(shape[:4]) + hr)
    q, k = fa._joined(*parts[:4])
    kw = dict(causal=causal, q_offset=q_offset)
    before = fa.LAUNCHES.count
    got = fa.flash_attention_split(*parts, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1 and got.shape == (b, sq, h, 128)
    want = fa.flash_attention_plain(q, k, parts[4], q_chunk=64, kv_chunk=128, **kw)
    atol, rtol = fa.kernel_tolerance(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, sq, h, 128), dtype=np.float32)).to(cuda_device, dt)
    grads = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in parts]
        fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
        fa.flash_attention_split(*leaves, **kw).backward(dout)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (1, 1)
        grads.append([t.grad for t in leaves])
    out, lse = fa._forward(q, k, parts[4], q_chunk=512, kv_chunk=1024, with_lse=True, **kw)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, parts[4], out, dout, lse, q_chunk=64,
                                              kv_chunk=128, **kw)
    dk = dk.float()  # dk_rope's heads summed in f32 for the reference
    want = (*fa._split_grads(dq, dk, 64, hr), dv)
    for name, g, w, t in zip(("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv"), grads[0], want,
                             parts):
        assert g.shape == t.shape and bool(torch.isfinite(g.float()).all()), name
        ok, err = _within_max(g, w, dt)
        assert ok, (name, err)
    assert all(torch.equal(x, y) for x, y in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads", [(1, 1000, 7), (3, 129, 5), (1, 64, 1), (2, 4096, 9)])
def test_cuda_persistent_mla_forward_over_work_lists_of_any_length(cuda_device, batch, seq,
                                                                   heads):
    """``flash_mla_fwd`` runs one block per SM over a list of (head, row
    tile) items: 56, 30, 1 and 576 items here, none a multiple of 132, so
    blocks take unequal numbers of items (and with one item, one block
    runs).  Causal and not, each within kernel_tolerance of the plain
    version, the same bits twice."""
    rng = np.random.default_rng(batch * seq + heads)
    q, k = (torch.from_numpy(rng.standard_normal((batch, seq, heads, 192), dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((batch, seq, heads, 128), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    items = batch * heads * -(-seq // fa.TC_ROWS)
    assert items % 132
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        assert torch.equal(got, again)


D64_WORK_LISTS = [  # (batch, seq, hq, hkv): items of G * (128 // G) folded rows
    (1, 1000, 7, 7),  # 56 items, a partial last row tile
    (3, 129, 10, 5),  # G=2: 3 * 5 * 3 = 45 items
    (1, 64, 1, 1),  # one item: one block runs
    (2, 4096, 9, 9),  # 576 items
    (1, 333, 12, 4),  # G=3: items of 126 rows (two zero rows each), 32 items
    (2, 300, 12, 2),  # G=6: items of 126 rows, 60 items
    (1, 64, 128, 1),  # G=128: an item is one query's group
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,hq,hkv", D64_WORK_LISTS)
def test_cuda_d64_forward_over_work_lists_of_any_length(cuda_device, batch, seq, hq, hkv):
    """bf16 at D = 64 runs ``flash_group_fwd<64>``: one block per SM over a list of
    (kv head, tile of whole query groups) items, none of these lists a
    multiple of 132 (with one item, one block runs).  Causal and not, with
    a q_offset, each within kernel_tolerance of the plain version, the same
    bits twice, and ``out`` the same bits with the lse written beside it."""
    rng = np.random.default_rng(batch * seq + hq + hkv)
    q = torch.from_numpy(rng.standard_normal((batch, seq, hq, 64), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((batch, seq, hkv, 64), dtype=np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    g = hq // hkv
    items = batch * hkv * -(-seq * g // fa.tile_rows(torch.bfloat16, 64, g))
    assert items % 132
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    for causal, q_offset in ((True, 0), (False, 0), (True, 37)):
        kw = dict(causal=causal, q_offset=q_offset)
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        with_lse, lse = fa._forward(q, k, v, q_chunk=512, kv_chunk=1024, with_lse=True, **kw)
        want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)  # f32 sums, another order
        assert torch.equal(got, again) and torch.equal(got, with_lse)


@pytest.mark.cuda
def test_cuda_d64_forward_budget(cuda_device):
    """``flash_group_fwd<64>``'s real budget, causal and not: 132,224 bytes of
    shared memory (two Q, three K and three V stages), 384 threads, one
    block per SM, 168 registers at launch and no spill; and the tiling the
    Python side assumes (kernel_budget raises otherwise)."""
    for causal in (True, False):
        budget = fa.kernel_budget(torch.bfloat16, 64, causal=causal)
        assert budget["shared_bytes"] == fa.smem_bytes(64) == 132224
        assert budget["threads_per_block"] == 384 and budget["blocks_per_sm"] == 1
        assert budget["local_bytes"] == 0 and budget["num_regs"] <= 168


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_at_mla_heads_runs_through_autograd(cuda_device, dtype):
    """MLA's (192, 128) through the autograd function on the card: one
    forward and one backward launch, q and k's gradients 192 wide, v's 128,
    each within kernel_tolerance of the plain backward's."""
    rng = np.random.default_rng(57)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device, dtype)
               for s in ((1, 64, 2, 192), (1, 64, 2, 192), (1, 64, 2, 128)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    out = fa.flash_attention(q, k, v)
    dout = torch.ones_like(out)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (1, 1)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = fa._forward(qd, kd, vd, causal=True, q_chunk=64, kv_chunk=64, q_offset=0,
                         with_lse=True)
    want = fa.flash_attention_bwd_plain(qd, kd, vd, o, dout, lse, q_chunk=64, kv_chunk=64)
    for t, w in zip((q, k, v), want):
        assert t.grad.shape == t.shape
        ok, err = _within_max(t.grad, w, dtype)
        assert ok, err


@pytest.mark.cuda
def test_cuda_mla_reduced_serves_like_the_cpu(cuda_device):
    """deepseek-v3 reduced with its own head dims (the kernel's MLA pair):
    one flash launch per layer in prefill, none in decode, the prefill's
    logits and latent caches and the greedy tokens equal to the CPU's.
    Matrices at std 0.02, as ``chip_smoke.py`` draws them: the reference's
    rule (1/sqrt(layer count) for a stacked leaf, 0.58 here) saturates the
    attention softmax, whose near-ties amplify f32 rounding layer by layer
    (2.9e-4 in a later layer's latent, against 1e-6 per op)."""
    cfg = mla.with_kernel_heads(get_config("deepseek-v3-671b").reduced())
    model = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=32), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=32), device=cuda_device)
    before = fa.LAUNCHES.count
    toks = card.generate(prompts, 6)
    assert fa.LAUNCHES.count - before == cfg.n_layers
    np.testing.assert_array_equal(toks, cpu.generate(prompts, 6))
    batch = {"tokens": torch.from_numpy(prompts)}
    want, cpu_state = cpu.prefill(batch, cpu.init_state(2))
    got, card_state = card.prefill({"tokens": batch["tokens"].to(cuda_device)}, card.init_state(2))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for key in ("dense", "moe"):
        for a, b in zip(cpu_state[key], card_state[key]):
            for name in ("ckv", "k_rope"):
                torch.testing.assert_close(b[name].cpu(), a[name], atol=1e-4, rtol=1e-4)


# -- the flash backward -------------------------------------------------------------

BWD_SHAPES = [  # (B, Sq, Skv, Hq, Hkv, D, Dv, causal, q_offset)
    (2, 1024, 1024, 32, 8, 128, 128, True, 0),  # the training shape (qwen3-4b)
    (1, 100, 100, 4, 1, 64, 64, True, 0),  # ragged, G=4
    (1, 100, 100, 4, 4, 32, 32, False, 0),  # ragged, G=1, non-causal
    (2, 64, 200, 8, 2, 64, 64, True, 136),  # Sq < Skv, queries continuing a prefix
    (1, 64, 200, 4, 4, 32, 32, False, 0),  # Sq < Skv, non-causal
    (1, 130, 130, 8, 2, 128, 128, True, 0),  # a ragged second tile at D=128
    (1, 77, 77, 12, 4, 128, 128, True, 0),  # G=3: Sq * G = 231, no multiple of any row tile
    (2, 1024, 1024, 16, 8, 64, 64, True, 0),  # granite-moe-1b's training shape: D=64, G=2
    (4, 1024, 1024, 32, 32, 64, 64, True, 0),  # zamba2-1.2b's shared block: D=64, G=1
    (2, 1024, 1024, 32, 32, 64, 64, True, 0),  # zamba2-1.2b's training shape: D=64, G=1
    (4, 1500, 1500, 6, 6, 64, 64, False, 0),  # whisper-tiny's encoder, non-causal, ragged
    (4, 16, 1500, 6, 6, 64, 64, False, 0),  # whisper-tiny's cross-attention, Sq != Skv
    (2, 448, 1500, 6, 6, 64, 64, False, 0),  # whisper-tiny's cross-attention in training
    (2, 448, 448, 6, 6, 64, 64, True, 0),  # whisper-tiny's decoder self-attention in training
    (2, 1024, 1024, 128, 128, 192, 128, True, 0),  # deepseek-v3's MLA training shape, G=1
    (1, 100, 100, 8, 8, 192, 128, True, 0),  # MLA, ragged
    (2, 64, 200, 8, 8, 192, 128, True, 136),  # MLA, Sq < Skv after a prefix
    (1, 130, 333, 4, 4, 192, 128, False, 0),  # MLA, Sq < Skv, non-causal, ragged
]


def _bwd_inputs(shape, dtype, device, seed):
    """q, k (D), v, dout (Dv) on the card (bf16 or f32) and the forward's out, lse."""
    b, sq, skv, hq, hkv, d, dv, causal, q_offset = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv)))
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, sq, hq, dv), dtype=np.float32)).to(device, dtype)
    out, lse = fa._forward(q, k, v, causal=causal, q_chunk=512, kv_chunk=1024,
                           q_offset=q_offset, with_lse=True)
    return q, k, v, dout, out, lse


def _within_max(got, want, dtype):
    """kernel_tolerance scaled to the gradient's largest magnitude."""
    atol, rtol = fa.kernel_tolerance(dtype)
    err = (got.float() - want.float()).abs().max().item()
    return err <= atol + rtol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_matches_plain_version(cuda_device, shape, dtype):
    *_, causal, q_offset = shape
    q, k, v, dout, out, lse = _bwd_inputs(shape, dtype, cuda_device, seed=60)
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal,
                                        q_chunk=64, kv_chunk=128, q_offset=q_offset)
    before = fa.BWD_LAUNCHES.count
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES.count == before + 1
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and bool(torch.isfinite(g.float()).all())
        ok, err = _within_max(g, w, dtype)
        assert ok, (name, err, w.float().abs().max().item())


@pytest.mark.cuda
# qwen3-4b's, MLA's, then D=64 (flash_bwd_d64): whisper-tiny's encoder (G=1,
# non-causal) and granite-moe's training shape (G=2)
@pytest.mark.parametrize("shape", [BWD_SHAPES[0], BWD_SHAPES[14], BWD_SHAPES[10],
                                   BWD_SHAPES[7]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_is_deterministic(cuda_device, dtype, shape):
    causal = shape[7]
    q, k, v, dout, out, lse = _bwd_inputs(shape, dtype, cuda_device, seed=61)
    first = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_forward_with_lse_keeps_out(cuda_device, dtype):
    """out is the same bits with and without lse; lse against the plain
    version's within 1e-5 (f32 sums in another order)."""
    for shape in BWD_SHAPES[1:]:
        b, sq, skv, hq, hkv, d, dv, causal, q_offset = shape
        q, k, v, *_ = _bwd_inputs(shape, dtype, cuda_device, seed=62)
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_offset)
        bare, none = fa._forward(q, k, v, with_lse=False, **kw)
        out, lse = fa._forward(q, k, v, with_lse=True, **kw)
        _, want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert none is None and torch.equal(out, bare)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_q_k_v_get_gradients_through_the_kernels(cuda_device):
    """Through the autograd function on the card: one forward and one
    backward launch, and gradients equal to the kernels' own call."""
    shape = (2, 200, 200, 8, 2, 64, True, 0)
    q, k, v = (t.to(cuda_device).requires_grad_() for t in _qkv(shape, torch.bfloat16, 63))
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device).to(torch.bfloat16)
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (1, 1)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = fa._forward(qd, kd, vd, causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                         with_lse=True)
    want = fa.flash_attention_bwd(qd, kd, vd, o, dout, lse)
    for t, w in zip((q, k, v), want):
        assert t.grad is not None and torch.equal(t.grad, w)
    with torch.no_grad():  # serving: the forward alone
        assert fa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.cuda
def test_cuda_flash_backward_reads_strided_out_and_dout(cuda_device):
    """bf16 out and dout that are views, as autograd may hand them over: out
    with its heads ahead of the sequence in memory, dout a slice of a wider
    tensor (16-byte rows, read in place) and a slice off 16 bytes (copied
    by the wrapper); out off 16 bytes too (copied: the delta pass reads it
    16 bytes at a time).  The gradients are those of contiguous copies."""
    shape = (2, 200, 200, 8, 2, 128, 128, True, 0)
    q, k, v, dout, out, lse = _bwd_inputs(shape, torch.bfloat16, cuda_device, seed=64)
    d = dout.shape[-1]
    out_t = out.transpose(1, 2).contiguous().transpose(1, 2)
    aligned = torch.zeros((*dout.shape[:3], 2 * d), dtype=dout.dtype, device=cuda_device)
    aligned[..., :d] = dout
    offset = torch.zeros((*dout.shape[:3], 2 * d), dtype=dout.dtype, device=cuda_device)
    offset[..., 1:d + 1] = dout
    out_off = torch.zeros((*out.shape[:3], 2 * d), dtype=out.dtype, device=cuda_device)
    out_off[..., 1:d + 1] = out
    assert not out_t.is_contiguous() and fa._rows_aligned(aligned[..., :d])
    assert not fa._rows_aligned(offset[..., 1:d + 1])
    assert not fa._rows_aligned(out_off[..., 1:d + 1])
    want = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    in_place = fa.flash_attention_bwd(q, k, v, out_t, aligned[..., :d], lse)
    copied = fa.flash_attention_bwd(q, k, v, out_t, offset[..., 1:d + 1], lse)
    out_copied = fa.flash_attention_bwd(q, k, v, out_off[..., 1:d + 1], dout, lse)
    torch.cuda.synchronize()
    for g, h, o, w in zip(in_place, copied, out_copied, want):
        assert torch.equal(g, w) and torch.equal(h, w) and torch.equal(o, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,threads", [(torch.float32, 256), (torch.bfloat16, 384)])
def test_cuda_flash_backward_budget(cuda_device, dtype, threads):
    """Within 227 KB a block, no spills, at least one block per SM, and the
    tiling the Python side assumes (bwd_budget raises otherwise).  The bf16
    kernels are warp-specialised: 168 registers a thread at launch, the pool
    that setmaxnreg hands from the producer to the consumers.  One kernel
    spilled until PR 24: bf16 dK/dV at MLA's (192, 128), 104-112 bytes of
    stack; its consumers now split the products (flash_bwd_dkdv_mla) and it
    is held to 0 with the rest."""
    for d, dv in fa.BWD_HEAD_DIMS:
        for causal in (True, False):
            budget = fa.bwd_budget(dtype, d, causal=causal, dv=dv)
            for name, smem in zip(("dkdv", "dq"), fa.bwd_smem_bytes(d, dtype, dv)):
                assert budget[name]["shared_bytes"] == smem <= 232448
                assert budget[name]["local_bytes"] == 0 and budget[name]["blocks_per_sm"] >= 1
                assert budget[name]["threads_per_block"] == threads
                if dtype == torch.bfloat16:
                    assert budget[name]["num_regs"] == 168
            if dtype == torch.bfloat16 and d == dv == 64:  # one kernel, flash_bwd_d64, for both
                assert budget["dkdv"] == budget["dq"]
                assert budget["dkdv"]["shared_bytes"] == 199824
            if dtype == torch.bfloat16 and d == dv == 128:  # one kernel, flash_bwd_d128, for both
                assert budget["dkdv"] == budget["dq"]
                assert budget["dkdv"]["shared_bytes"] == 232032


@pytest.mark.cuda
@pytest.mark.parametrize("load", ["below", "at", "above"])
def test_cuda_d64_work_list_below_at_and_above_the_sm_count(cuda_device, load):
    """flash_bwd_d64 runs min(items, SMs) blocks that claim the items of a
    work list: fewer items than SMs (blocks with one item), as many (some
    blocks may claim two and leave another none) and more (blocks walk
    several).  A head of 64 queries and 64 keys holds one dK/dV pair and
    one dQ row tile; the heads take the item count where the card's SM
    count puts it.  Every form against the plain version, twice bitwise, at
    G=1 causal and G=2 non-causal."""
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    heads = {"below": max(n_sm // 4, 1), "at": max(n_sm // 2, 1), "above": 3 * n_sm // 2}[load]
    for g, causal in ((1, True), (2, False)):
        shape = (1, 64, 64, heads * g, heads, 64, 64, causal, 0)
        assert fa.persistent_bwd_plan(1, 64, 64, heads * g, heads,
                                      causal=causal)[0]["items"] == 2 * heads
        q, k, v, dout, out, lse = _bwd_inputs(shape, torch.bfloat16, cuda_device, seed=65)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
        torch.cuda.synchronize()
        for name, g_, w, a in zip(("dq", "dk", "dv"), got, want, again):
            ok, err = _within_max(g_, w, torch.bfloat16)
            assert ok and torch.equal(g_, a), (name, g, err)


D64_TRAIN_SHAPES = [  # (batch, sq, skv, hq, hkv, causal, dK/dV items, dQ items): training's
    (2, 1024, 1024, 16, 8, True, 128, 256),  # granite-moe-1b-a400m, G=2
    (2, 1024, 1024, 32, 32, True, 512, 512),  # zamba2-1.2b's shared block
    (2, 1500, 1500, 6, 6, False, 144, 144),  # whisper-tiny's encoder
    (2, 448, 1500, 6, 6, False, 144, 48),  # its cross-attention
    (2, 448, 448, 6, 6, True, 48, 48),  # its decoder's self-attention
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", D64_TRAIN_SHAPES, ids=["granite", "zamba", "encoder", "cross",
                                                         "self"])
def test_cuda_d64_work_list_holds_each_item_once(cuda_device, shape):
    """flash_bwd_d64's own work list (the library's plan, each item decoded
    by the blocks' decoder) at the main paths' training shapes, on the
    card's SMs, on fewer and on more: each dK/dV pair (key tiles 2j and 2j
    + 1) and each dQ row tile of every head exactly once, the list starting
    with the kind the plan puts first."""
    b, sq, skv, hq, hkv, causal, n_kv, n_q = shape
    g = hq // hkv
    n_kt, n_qt = -(-skv // 64), -(-sq * g // (128 // g * g))
    heads = [(i, h) for i in range(b) for h in range(hkv)]
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for sms in (n_sm, 8, 1024):
        plan, items = fa.persistent_bwd_plan(b, sq, skv, hq, hkv, causal=causal, n_sm=sms)
        assert plan["items"] == len(items) == len(set(items)) == n_kv + n_q
        assert {it for it in items if it[0] == "dkdv"} == {
            ("dkdv", i, h, j) for i, h in heads for j in range((n_kt + 1) // 2)}
        assert {it for it in items if it[0] == "dq"} == {
            ("dq", i, h, t) for i, h in heads for t in range(n_qt)}
        assert items[0][0] == ("dq" if plan["q_first"] else "dkdv")


# bf16 at D = Dv = 128: flash_group_fwd<128> and flash_bwd_d128, at the
# registry's G (qwen3-4b and minitron-8b 4, yi-6b 8, internvl2-26b 6,
# granite-34b 48) and G = 1; (hq, hkv)
D128_GROUPS = [(4, 4), (32, 8), (48, 8), (32, 4), (48, 1)]
D128_FORMS = [(True, 0), (False, 0), (True, 367)]  # (causal, q_offset), Sq = 333 < Skv = 700


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", D128_GROUPS, ids=lambda x: str(x))
def test_cuda_d128_forward_matches_plain_at_every_group(cuda_device, hq, hkv):
    """The persistent forward at D=128 (items of G * (128 // G) folded rows:
    126 at G=6, 96 at G=48) against its plain version at Sq = 333 != Skv =
    700, causal and not, with a q_offset: within kernel_tolerance, lse
    within 1e-5, the same bits twice and with lse, one launch of
    ``flash_group_fwd<128>`` a call."""
    rng = np.random.default_rng(hq * 131 + hkv)
    q = torch.from_numpy(rng.standard_normal((2, 333, hq, 128), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 700, hkv, 128), dtype=np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    atol, rtol = fa.kernel_tolerance(torch.bfloat16)
    for causal, q_offset in D128_FORMS:
        kw = dict(causal=causal, q_offset=q_offset)
        before = fa.LAUNCHES_BY_KERNEL.get("flash_group_fwd<128>", 0)
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        assert fa.LAUNCHES_BY_KERNEL["flash_group_fwd<128>"] == before + 2
        with_lse, lse = fa._forward(q, k, v, q_chunk=512, kv_chunk=1024, with_lse=True, **kw)
        want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)  # f32 sums, another order
        assert torch.equal(got, again) and torch.equal(got, with_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", D128_GROUPS, ids=lambda x: str(x))
def test_cuda_d128_backward_matches_plain_at_every_group(cuda_device, hq, hkv):
    """The persistent backward at D=128 (``flash_bwd_delta_vec<128>``, then
    ``flash_bwd_d128``) against its plain version at the forms of the
    forward's test: each gradient within kernel_tolerance of its max, the
    same bits twice, one call counted under ``flash_bwd_d128``."""
    for causal, q_offset in D128_FORMS:
        shape = (2, 333, 700, hq, hkv, 128, 128, causal, q_offset)
        q, k, v, dout, out, lse = _bwd_inputs(shape, torch.bfloat16, cuda_device,
                                              seed=hq + hkv + q_offset)
        kw = dict(causal=causal, q_offset=q_offset)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        before = fa.LAUNCHES_BY_KERNEL.get("flash_bwd_d128", 0)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES_BY_KERNEL["flash_bwd_d128"] == before + 2
        for name, g_, w, a in zip(("dq", "dk", "dv"), got, want, again):
            ok, err = _within_max(g_, w, torch.bfloat16)
            assert ok and torch.equal(g_, a), (name, causal, q_offset, err)


D128_TRAIN_SHAPES = [  # (batch, sq, skv, hq, hkv, causal): training's, B=2, S=1,024
    (2, 1024, 1024, 32, 8, True),  # qwen3-4b and minitron-8b, G=4
    (2, 1024, 1024, 32, 4, True),  # yi-6b, G=8
    (2, 1024, 1024, 48, 8, True),  # internvl2-26b, G=6: dQ items of 126 rows
    (2, 1024, 1024, 48, 1, True),  # granite-34b, G=48: dK/dV row tiles of 48, dQ items of 96
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", D128_TRAIN_SHAPES, ids=["qwen3", "yi", "internvl2", "granite34"])
def test_cuda_d128_work_list_holds_each_item_once(cuda_device, shape):
    """flash_bwd_d128's work list (the library's plan, each item decoded by
    the blocks' decoder; the items flash_bwd_d64 walks) at the D=128
    architectures' training shapes, on the card's SMs, on fewer and on
    more: each dK/dV pair and each dQ row tile of whole query groups of
    every head exactly once."""
    b, sq, skv, hq, hkv, causal = shape
    g = hq // hkv
    n_kt, n_qt = -(-skv // 64), -(-sq * g // (128 // g * g))
    heads = [(i, h) for i in range(b) for h in range(hkv)]
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for sms in (n_sm, 8, 1024):
        plan, items = fa.persistent_bwd_plan(b, sq, skv, hq, hkv, causal=causal, n_sm=sms)
        assert plan["items"] == len(items) == len(set(items)) == len(heads) * (
            (n_kt + 1) // 2 + n_qt)
        assert {it for it in items if it[0] == "dkdv"} == {
            ("dkdv", i, h, j) for i, h in heads for j in range((n_kt + 1) // 2)}
        assert {it for it in items if it[0] == "dq"} == {
            ("dq", i, h, t) for i, h in heads for t in range(n_qt)}


@pytest.mark.cuda
def test_cuda_d128_kernels_have_no_spill(cuda_device):
    """The D=128 kernels' real budgets, causal and not: the forward 230,512
    bytes (one Q, three K and three V stages), the backward one kernel for both
    roles in 232,032 bytes (two 64 KB operand slots and three 32 KB ring
    stages), 384 threads, one block per SM, 168 registers at launch and no
    spill."""
    for causal in (True, False):
        fwd = fa.kernel_budget(torch.bfloat16, 128, causal=causal)
        assert fwd["shared_bytes"] == fa.smem_bytes(128) == 230512
        bwd = fa.bwd_budget(torch.bfloat16, 128, causal=causal)
        assert bwd["dkdv"] == bwd["dq"] and bwd["dq"]["shared_bytes"] == 232032
        for budget in (fwd, bwd["dq"]):
            assert budget["threads_per_block"] == 384 and budget["blocks_per_sm"] == 1
            assert budget["local_bytes"] == 0 and budget["num_regs"] <= 168


@pytest.mark.cuda
def test_cuda_reduced_train_step_matches_the_cpu(cuda_device):
    """One step's loss and gradients through the kernels (forward, its
    remat recompute and the backward) against the CPU's plain versions, f32,
    TF32 off: within 1e-4 (loss, relative) and 1e-3 of each leaf's max."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.models import common
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("qwen3-4b").reduced()
    model = common.trainable(registry.get(cfg).init(torch.Generator().manual_seed(0), cfg))
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 96, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=64, kv_chunk=64)
    grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    cgrads, cmetrics = grad_fn(card, make_train_batch(pipe, PipelineState(), cfg,
                                                      device=cuda_device)[0])
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (2 * cfg.n_layers,
                                                                      cfg.n_layers)
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    for name, g in grads.items():
        err = (cgrads[name].cpu() - g).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item(), name


@pytest.mark.cuda
def test_cuda_train_loop_resumes_bitwise(cuda_device, tmp_path):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    cfg = get_config("qwen3-4b").reduced()

    def tcfg(steps, directory):
        return loop.TrainConfig(steps=steps, seq_len=64, global_batch=2, log_every=1,
                                checkpoint_dir=directory,
                                opt=AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4))

    quiet = lambda line: None  # noqa: E731
    straight = loop.train(cfg, tcfg(4, None), log=quiet, device=cuda_device)
    loop.train(cfg, tcfg(2, str(tmp_path)), log=quiet, device=cuda_device)
    resumed = loop.train(cfg, tcfg(4, str(tmp_path)), log=quiet, device=cuda_device)
    assert [h["loss"] for h in straight["history"][2:]] == [h["loss"] for h in resumed["history"]]
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert a.is_cuda and torch.equal(a, b), n


# -- the MoE family -----------------------------------------------------------------


def _moe_layer(device, dtype, seed):
    """granite-moe-1b's MoE layer (d_model 1,024, 32 experts, top-8, d_ff 512)
    with random weights and a (2, 1,024, 1,024) input, its training shape."""
    from repro_torch.models import common, moe

    cfg = get_config("granite-moe-1b-a400m")
    params = common.init_params(moe.spec(cfg), torch.Generator(device=device).manual_seed(seed))
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn((2, 1024, cfg.d_model), generator=torch.Generator(device=device).manual_seed(
        seed + 1), device=device).to(dtype).requires_grad_()
    return cfg, params, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_moe_dispatch_and_combine_same_bits_twice(cuda_device, dtype):
    """The MoE layer at granite-moe-1b's training shape, forward and
    backward, twice: the same bits (the dispatch and combine are gathers
    both ways; no atomics)."""
    from repro_torch.models import moe

    cfg, params, x = _moe_layer(cuda_device, dtype, seed=70)
    dout = torch.randn(x.shape, generator=torch.Generator(device=cuda_device).manual_seed(72),
                       device=cuda_device).to(dtype)
    runs = []
    for _ in range(2):
        out, aux = moe.apply(params, x, cfg)
        loss = (out.float() * dout.float()).sum() + aux
        grads = torch.autograd.grad(loss, [x] + list(params.values()))
        runs.append([out, aux] + list(grads))
    torch.cuda.synchronize()
    for name, a, b in zip(["out", "aux", "x"] + list(params), *runs):
        assert torch.equal(a, b), name
    assert all(bool(torch.isfinite(g.float()).all()) for g in runs[0])


@pytest.mark.cuda
def test_cuda_moe_gathers_equal_the_cpu_bitwise(cuda_device):
    """The routing, the slot maps and the dispatch/combine gathers on the
    card equal the CPU's bit for bit at granite-moe-1b's layer shape (f32
    router inputs from the CPU: the maps depend on the indices alone)."""
    from repro_torch.models import moe

    cfg, params, x = _moe_layer(torch.device("cpu"), torch.bfloat16, seed=74)
    x = x.detach()
    _, idx, _ = moe._route(params, x, cfg)
    cap = moe.capacity(x.shape[1], cfg)
    found = []
    for dev in ("cpu", cuda_device):
        tok, ks = moe._dispatch_indices(idx.to(dev), x.shape[1], cfg, cap)
        maps = moe._slot_maps(tok, ks, x.shape[1], cfg.experts_per_token)
        xs = moe.gather_rows_plain(x.to(dev).reshape(-1, cfg.d_model), maps.token)
        back = moe.gather_rows_plain(xs, maps.choices)
        found.append([t.cpu() for t in (tok, ks, maps.choices, maps.assignment_row, xs, back)])
    for name, a, b in zip(("tok", "kslot", "choices", "assignment_row", "dispatch", "combine"),
                          *found):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_moe_reduced_train_step_matches_the_cpu(cuda_device):
    """granite-moe-1b reduced, matrices at std 0.02: one step's loss and
    gradients (router included) through the kernels against the CPU's
    plain versions, f32, TF32 off: within 1e-4 (loss, relative) and 1e-3 of
    each leaf's max; the routing of every layer equal."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.models import common, moe
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = common.trainable(registry.get(cfg).init(torch.Generator().manual_seed(0), cfg))
    # matrices at std 0.02: the reference's rule gives this model (no
    # qk-norm) a saturated attention softmax whose near-ties amplify the
    # rounding of every op past the tolerance
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 96, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=64, kv_chunk=64)
    route, found = moe._route, {}

    def recording(where):
        def rec(params, x, c):
            out = route(params, x, c)
            found.setdefault(where, []).append(out[1].cpu())
            return out
        return rec

    try:
        moe._route = recording("cpu")
        grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
        moe._route = recording("card")
        fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
        cgrads, cmetrics = grad_fn(card, make_train_batch(pipe, PipelineState(), cfg,
                                                          device=cuda_device)[0])
        torch.cuda.synchronize()
    finally:
        moe._route = route
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (2 * cfg.n_layers,
                                                                      cfg.n_layers)
    assert len(found["cpu"]) == len(found["card"]) == 2 * cfg.n_layers  # forward + recompute
    assert all(torch.equal(a, b) for a, b in zip(found["cpu"], found["card"]))
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    for name, g in grads.items():
        err = (cgrads[name].cpu() - g).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item(), name


@pytest.mark.cuda
def test_cuda_moe_train_loop_resumes_bitwise(cuda_device, tmp_path):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    cfg = get_config("granite-moe-1b-a400m").reduced()

    def tcfg(steps, directory):
        return loop.TrainConfig(steps=steps, seq_len=64, global_batch=2, log_every=1,
                                checkpoint_dir=directory,
                                opt=AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4))

    quiet = lambda line: None  # noqa: E731
    straight = loop.train(cfg, tcfg(4, None), log=quiet, device=cuda_device)
    loop.train(cfg, tcfg(2, str(tmp_path)), log=quiet, device=cuda_device)
    resumed = loop.train(cfg, tcfg(4, str(tmp_path)), log=quiet, device=cuda_device)
    for key in ("loss", "nll", "aux"):
        assert [h[key] for h in straight["history"][2:]] == [h[key] for h in resumed["history"]]
    for (n, a), (_, b) in zip(straight["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert a.is_cuda and torch.equal(a, b), n


# -- the zamba hybrid ----------------------------------------------------------------


def _zamba_reduced():
    """zamba2-1.2b reduced (5 Mamba2 layers, the shared block after every 2:
    2 applications, a tail layer; attention D=32, G=2) with matrices at std
    0.02: the reference's init rule (std 1/sqrt(5) on the stacked Mamba2
    leaves) drives dt and the SSD's products to magnitudes where f32
    against f64 on the CPU alone parts by 1e-4 of the logits and 1e-3 of a
    gradient; at 0.02 by ~1e-6."""
    cfg = get_config("zamba2-1.2b").reduced()
    model = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return cfg, model


def _max_share(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.cpu().double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.cuda
def test_cuda_zamba_reduced_serves_like_the_cpu(cuda_device):
    """A 20-token prefill (one flash launch per shared application) and 5
    decode steps (none) of the CPU's tokens, on the card and on the CPU, f32,
    TF32 off: the logits and every state leaf (the Mamba2 layers' ssm and
    conv, the applications' k and v) within 1e-3 of their max."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _zamba_reduced()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=32), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=32), device=cuda_device)
    toks = torch.from_numpy(cpu.generate(prompts, 6))
    found = []
    for eng in (cpu, card):
        t = toks.to(eng.device)
        state = eng.init_state(2)
        before = fa.LAUNCHES.count
        lg, state = eng.prefill({"tokens": t[:, :20]}, state)
        prefill_launches = fa.LAUNCHES.count - before
        out = [lg]
        for i in range(5):
            lg, state = eng.decode(t[:, 20 + i:21 + i], state, 20 + i)
            out.append(lg)
        found.append((torch.cat(out, 1), state, prefill_launches, fa.LAUNCHES.count - before))
    (lc, sc, _, _), (lg, sg, pre, total) = found
    assert (pre, total) == (zamba._counts(cfg)[0], zamba._counts(cfg)[0]) == (2, 2)
    assert _max_share(lg, lc) <= 1e-3
    for key, names in (("mamba", ("ssm", "conv")), ("attn", ("k", "v"))):
        for i, (a, b) in enumerate(zip(sg[key], sc[key])):
            for name in names:
                assert a[name].is_cuda and _max_share(a[name], b[name]) <= 1e-3, (key, i, name)


@pytest.mark.cuda
def test_cuda_zamba_reduced_train_step_matches_the_cpu(cuda_device):
    """One step's loss and gradients through the kernels (the shared block's
    flash forward and backward once per application; the Mamba2 layers are
    rematted, the block is not) against the CPU's plain versions, f32, TF32
    off: within 1e-4 (loss, relative) and 1e-3 of each leaf's max."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _zamba_reduced()
    model = common.trainable(model)
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 128, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=64, kv_chunk=64)
    grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    cgrads, cmetrics = grad_fn(card, make_train_batch(pipe, PipelineState(), cfg,
                                                      device=cuda_device)[0])
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (2, 2)
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    for name, g in grads.items():
        assert _max_share(cgrads[name], g) <= 1e-3, name


@pytest.mark.cuda
def test_cuda_mamba2_decode_state_matches_the_cpu(cuda_device):
    """zamba2-1.2b's Mamba2 mixer at full width (d_model 2,048, 64 heads of
    64, state 64) in f32: a 128-token prefill with a state, then one decode
    step, on the card and on the CPU: the outputs and the ssm and conv
    states within 1e-4 of their max (matrices at std 0.02)."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype="float32")
    params = common.init_params(mamba2.spec(cfg), torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    params = {k: (torch.randn(v.shape, generator=gen) * 0.02 if v.dim() >= 2 else v)
              for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 129, cfg.d_model), dtype=np.float32))
    found = []
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        st = mamba2.init_state(cfg, 2, device=dev)
        y1, st = mamba2.apply(p, x[:, :128].to(dev), cfg, state=st)
        y2, st = mamba2.apply(p, x[:, 128:].to(dev), cfg, state=st)
        found.append((y1, y2, st["ssm"], st["conv"]))
    for name, a, b in zip(("prefill", "decode", "ssm", "conv"), found[1], found[0]):
        assert a.is_cuda and _max_share(a, b) <= 1e-4, name


# -- the xLSTM and whisper families -------------------------------------------------------


def _reduced_at(arch: str, std: float = 0.02, **fields):
    """``arch``'s reduced config in f32 (``fields`` replaced) with its
    matrices at ``std``."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    model = registry.get(cfg).init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return cfg, model


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    items = state.values() if isinstance(state, dict) else state
    return [x for v in items for x in _leaves(v)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
def test_cuda_reduced_serves_like_the_cpu(cuda_device, arch):
    """A 20-token prefill and 5 decode steps of the CPU's tokens (whisper:
    after 64 seeded frames), on the card and on the CPU, f32, TF32 off:
    the logits and every state leaf (xLSTM's cell states, whisper's self and
    cross K/V) within 1e-3 of their max; whisper's prefill makes one flash
    launch per encoder layer and two per decoder layer, its decode none;
    xLSTM none at all."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at(arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 20), dtype=np.int32)
    extras = {}
    if cfg.is_encoder_decoder:
        extras["frames"] = rng.standard_normal((2, cfg.encoder_len, cfg.d_model),
                                               dtype=np.float32)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=32), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=32), device=cuda_device)
    toks = torch.from_numpy(cpu.generate(prompts, 6, extras=extras or None))
    found = []
    for eng in (cpu, card):
        t = toks.to(eng.device)
        state = eng.init_state(2)
        before = fa.LAUNCHES.count
        lg, state = eng.prefill({"tokens": t[:, :20], **{
            k: torch.from_numpy(v).to(eng.device) for k, v in extras.items()}}, state)
        prefill_launches = fa.LAUNCHES.count - before
        out = [lg]
        for i in range(5):
            lg, state = eng.decode(t[:, 20 + i:21 + i], state, 20 + i)
            out.append(lg)
        found.append((torch.cat(out, 1), state, prefill_launches, fa.LAUNCHES.count - before))
    (lc, sc, _, _), (lg, sg, pre, total) = found
    want = cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.is_encoder_decoder else 0
    assert pre == total == want
    assert _max_share(lg, lc) <= 1e-3
    for i, (a, b) in enumerate(zip(_leaves(sg), _leaves(sc))):
        assert a.is_cuda and _max_share(a, b) <= 1e-3, i


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
def test_cuda_reduced_family_train_step_matches_the_cpu(cuda_device, arch):
    """One step's loss and gradients (whisper: the flash forward and backward
    kernels, the decoder rematted; xLSTM: plain PyTorch, each block
    rematted) against the CPU, f32, TF32 off: within 1e-4 (loss, relative)
    and 1e-3 of each leaf's max, or of 1e-4 of the largest gradient where
    that is larger (xLSTM's input-gate bias may have a gradient of exactly
    0, rounding noise on both)."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at(arch)
    model = common.trainable(model)
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=32, kv_chunk=32)
    grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    cgrads, cmetrics = grad_fn(card, make_train_batch(pipe, PipelineState(), cfg,
                                                      device=cuda_device)[0])
    torch.cuda.synchronize()
    if cfg.is_encoder_decoder:  # encoder once, the decoder's self + cross twice (remat)
        want = (cfg.n_encoder_layers + 4 * cfg.n_layers, cfg.n_encoder_layers + 2 * cfg.n_layers)
    else:
        want = (0, 0)
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == want
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    floor = 1e-4 * max(g.abs().max().item() for g in grads.values())
    for name, g in grads.items():
        err = (cgrads[name].cpu().double() - g.double()).abs().max().item()
        assert err <= 1e-3 * max(g.abs().max().item(), floor), name


# -- the VLM family ----------------------------------------------------------------------


def _vlm_patches(cfg, batch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, cfg.n_patches, cfg.d_model),
                                                       dtype=np.float32)


@pytest.mark.cuda
def test_cuda_vlm_reduced_serves_like_the_cpu(cuda_device):
    """internvl2-26b reduced (16 patch positions, 4/2 heads of 32, f32,
    TF32 off; matrices at std 0.02) with the same seeded patches on both
    devices: one flash launch per layer in prefill and none in decode; the
    greedy tokens equal the CPU's, and twice the same on the card; a
    24-token prefill and 5 decode steps of those tokens: the logits and
    every KV cache leaf within 1e-3 of their max."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at("internvl2-26b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    patches = _vlm_patches(cfg, 2, seed=1)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=40), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=40), device=cuda_device)
    want = cpu.generate(prompts, 6, extras={"patches": patches})
    before = fa.LAUNCHES.count
    got = card.generate(prompts, 6, extras={"patches": patches})
    assert fa.LAUNCHES.count - before == cfg.n_layers
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(card.generate(prompts, 6, extras={"patches": patches}), got)
    toks = torch.from_numpy(want)
    found = []
    for eng in (cpu, card):
        t, p = toks.to(eng.device), torch.from_numpy(patches).to(eng.device)
        lg, state = eng.prefill({"tokens": t[:, :24], "patches": p}, eng.init_state(2))
        out = [lg]
        for i in range(5):
            lg, state = eng.decode(t[:, 24 + i:25 + i], state, 24 + i)
            out.append(lg)
        found.append((torch.cat(out, 1), state))
    (lc, sc), (lg, sg) = found
    assert _max_share(lg, lc) <= 1e-3
    for i, (a, b) in enumerate(zip(_leaves(sg), _leaves(sc))):
        assert a.is_cuda and _max_share(a, b) <= 1e-3, i


@pytest.mark.cuda
def test_cuda_vlm_reduced_train_step_matches_the_cpu(cuda_device):
    """One step's loss and gradients on the pipeline's patches (drawn on the
    CPU and moved, so both devices train on the same) through the flash
    forward (twice a layer: remat) and backward (once a layer), against the
    CPU, f32, TF32 off: within 1e-4 (loss, relative) and 1e-3 of each leaf's
    max; the card's gradients and metrics twice, the same bits."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at("internvl2-26b")
    model = common.trainable(model)
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=32, kv_chunk=32)
    grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
    batch = make_train_batch(pipe, PipelineState(), cfg, device=cuda_device)[0]
    assert torch.equal(batch["patches"].cpu(), make_train_batch(pipe, PipelineState(), cfg)[0][
        "patches"])
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    cgrads, cmetrics = grad_fn(card, batch)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (2 * cfg.n_layers,
                                                                      cfg.n_layers)
    again, ametrics = grad_fn(card, batch)
    assert all(torch.equal(again[n], g) for n, g in cgrads.items())
    assert all(torch.equal(ametrics[k], v) for k, v in cmetrics.items())
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    for name, g in grads.items():
        err = (cgrads[name].cpu().double() - g.double()).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item(), name


# -- MQA at G = 48: granite-34b's heads ------------------------------------------------

# granite-34b's reduced config keeping its 48 query heads on one kv head over
# 2 layers, as tests/test_torch_dense_archs.py holds it against the reference,
# but at its own head dim of 128: the kernels are built for 32, 64 and 128,
# not the CPU tests' 16
G48 = {"n_heads": 48, "n_kv_heads": 1, "d_head": 128, "n_layers": 2}


@pytest.mark.cuda
def test_cuda_mqa_g48_serves_like_the_cpu(cuda_device):
    """granite-34b at G = 48 (f32, TF32 off, matrices at std 0.02): one
    flash launch per layer in prefill and none in decode; the greedy tokens
    equal the CPU's; a 24-token prefill and 5 decode steps of those tokens:
    the logits and every KV cache leaf within 1e-3 of their max."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at("granite-34b", **G48)
    assert cfg.n_heads // cfg.n_kv_heads == 48
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    cpu = ServeEngine(cfg, copy.deepcopy(model), ServeConfig(max_len=40), device="cpu")
    card = ServeEngine(cfg, model, ServeConfig(max_len=40), device=cuda_device)
    want = cpu.generate(prompts, 6)
    before = fa.LAUNCHES.count
    got = card.generate(prompts, 6)
    assert fa.LAUNCHES.count - before == cfg.n_layers
    np.testing.assert_array_equal(got, want)
    toks = torch.from_numpy(want)
    found = []
    for eng in (cpu, card):
        t = toks.to(eng.device)
        lg, state = eng.prefill({"tokens": t[:, :24]}, eng.init_state(2))
        out = [lg]
        for i in range(5):
            lg, state = eng.decode(t[:, 24 + i:25 + i], state, 24 + i)
            out.append(lg)
        found.append((torch.cat(out, 1), state))
    (lc, sc), (lg, sg) = found
    assert _max_share(lg, lc) <= 1e-3
    for i, (a, b) in enumerate(zip(_leaves(sg), _leaves(sc))):
        assert a.is_cuda and _max_share(a, b) <= 1e-3, i


@pytest.mark.cuda
def test_cuda_mqa_g48_train_step_matches_the_cpu(cuda_device):
    """granite-34b at G = 48: one step's loss and gradients through the
    flash forward (twice a layer: remat) and backward (once a layer)
    against the CPU, f32, TF32 off: within 1e-4 (loss, relative) and 1e-3 of
    each leaf's max, the separate head included."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.train import train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model = _reduced_at("granite-34b", **G48)
    model = common.trainable(model)
    card = copy.deepcopy(model).to(cuda_device)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 96, 2, seed=1))
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=32, kv_chunk=32)
    grads, metrics = grad_fn(model, make_train_batch(pipe, PipelineState(), cfg)[0])
    fwd, bwd = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
    cgrads, cmetrics = grad_fn(card, make_train_batch(pipe, PipelineState(), cfg,
                                                      device=cuda_device)[0])
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count - fwd, fa.BWD_LAUNCHES.count - bwd) == (2 * cfg.n_layers,
                                                                      cfg.n_layers)
    assert abs(cmetrics["loss"].item() - metrics["loss"].item()) <= 1e-4 * metrics["loss"].item()
    assert "lm_head" in grads
    for name, g in grads.items():
        err = (cgrads[name].cpu().double() - g.double()).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mesh_steps_equal_the_one_card_steps(cuda_device, tmp_path, dtype):
    """qwen3-4b reduced at head dim 128 (the kernels' D) trained 3 steps on a
    (1, 1) mesh of one NCCL rank (DTensor weights, ``local_map`` into the
    flash kernels) and on the card without a mesh, from the same weights:
    the same losses and the same bits in every leaf, and the same kernel
    launches by name."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.distributed import act_sharding, sharding
    from repro_torch.launch import mesh as meshes
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), d_head=128, dtype=dtype)
    api = registry.get(cfg)
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    tree = common.init_params(api.spec(cfg), torch.Generator().manual_seed(0))
    runs = {}
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"))
        rules = sharding.default_rules(sharding.logical_mesh(mesh))
        for on_mesh in (False, True):
            if on_mesh:
                params = api.from_tree(cfg, sharding.distribute_tree(tree, api.spec(cfg), mesh,
                                                                     rules))
            else:
                params = api.from_tree(cfg, {k: v for k, v in tree.items()}).to(cuda_device)
            params = common.trainable(params)
            state = adamw.init(params, opt)
            step = make_train_step(cfg, opt, q_chunk=64, kv_chunk=64)
            pipe, ps, losses = TokenPipeline(DataConfig(cfg.vocab_size, 256, 2, seed=1)), \
                PipelineState(), []
            fa.LAUNCHES_BY_KERNEL.clear()
            ctx = act_sharding.use_rules(mesh, rules) if on_mesh else contextlib.nullcontext()
            with ctx:
                for _ in range(3):
                    batch, ps = make_train_batch(pipe, ps, cfg, device=cuda_device)
                    if on_mesh:
                        batch = sharding.distribute_batch(batch, mesh, rules)
                    params, state, m = step(params, state, batch)
                    losses.append(float(m["loss"]))
            leaves = [p.detach().to_local() if on_mesh else p.detach()
                      for p in params.parameters()]
            runs[on_mesh] = (losses, leaves, dict(fa.LAUNCHES_BY_KERNEL))
    finally:
        torch.distributed.destroy_process_group()
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    assert runs[True][2] == runs[False][2] and sum(runs[True][2].values()) == 3 * 3 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 4])
def test_cuda_ranked_slabs_of_one_nccl_rank_equal_one_process(cuda_device, tmp_path, hosts):
    """One NCCL rank owning ``hosts`` slabs at L=8: first-touch init,
    ``step``, ``fused_step(3)``, the stencil at both ``overlap`` values and
    depths 1 and 2, and fused and composed CG each equal the one-process
    slab plan bitwise (the rank holds every slab; the CG reductions go
    through the group), with each kernel's launches counted by name."""
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.plan import EngineConfig, build_plan
    from repro_torch.kernels import su3_stencil
    from repro_torch.launch import mesh as meshes

    cfg = EngineConfig(L=8, tile=64)
    spec = meshes.MeshSpec(hosts=hosts)
    u_cg, b_cg = _cg_measure_problem(8)

    def run(plan) -> dict:
        a, b, _, _ = plan.init_data()
        u, v = _slab_field(plan, 9)
        out = {"a": a.clone(), "step": plan.step(a, b), "fused3": plan.fused_step(3)(a.clone(), b)}
        for overlap in (True, False):
            for depth in (1, 2):
                out[f"stencil {overlap} {depth}"] = plan.stencil_step(overlap, depth)(u, v)
        cu, cb = plan.pack_gauge(u_cg), plan.pack_rhs(b_cg)
        for fused in (True, False):
            res = plan.cg_solve(cu, cb, fused=fused, overlap=True)
            out[f"cg {fused}"], out[f"cg {fused} iterations"] = res.x_p, res.iterations
        torch.cuda.synchronize()
        return out

    want = run(build_plan(cfg, spec.resolve(cuda_device)))
    counters = (su3_matmul.LAUNCHES, su3_stencil.STENCIL_LAUNCHES, su3_stencil.CG_LAUNCHES)
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        plan = build_plan(cfg, spec.resolve())
        assert plan.is_ranked and (plan.world, plan.local_sites) == (1, 8**4)
        before = {c.name: c.count for c in counters}
        got = run(plan)
        launched = {c.name: c.count - before[c.name] for c in counters}
    finally:
        torch.distributed.destroy_process_group()
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w == 9, key
        else:
            assert torch.equal(got[key].view(torch.int32), w.view(torch.int32)), key
    dispatched = want["cg True iterations"] + 1  # the residual is read one iteration late
    assert launched == {su3_matmul.LAUNCHES.name: 2,
                        su3_stencil.STENCIL_LAUNCHES.name: 2 + 5 + 1 + 2 + 2 * dispatched,
                        su3_stencil.CG_LAUNCHES.name: 2 * dispatched}


@pytest.mark.cuda
@pytest.mark.parametrize("alias", [False, True])
def test_cuda_multiply_kernels_write_into_a_given_output(cuda_device, alias):
    """``out=`` takes C in a given tensor (a block's rows of a batch) with
    the bits of a fresh output; ``alias`` and ``out`` are refused together."""
    a, b = (x.to(cuda_device) for x in _inputs("float32", False, 40))
    batch = torch.stack([a, torch.roll(a, 7, -1), torch.roll(a, 13, -1)]).contiguous()
    bs = torch.stack([b, b, b]).contiguous()
    ks = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda_device)
    want = su3_matmul.su3_mult_planar(batch, bs, tile=64, k_iters=2)
    want_mega = su3_matmul.su3_mult_planar_batched(batch, bs, ks, tile=64, max_k=4)
    out, out_mega = torch.empty_like(batch), torch.empty_like(batch)
    for lo, hi in ((0, 1), (1, 3)):  # two blocks' rows
        su3_matmul.su3_mult_planar(batch[lo:hi], bs[lo:hi], tile=64, k_iters=2,
                                   out=out[lo:hi])
        su3_matmul.su3_mult_planar_batched(batch[lo:hi], bs[lo:hi], ks[lo:hi], tile=64,
                                           max_k=4, out=out_mega[lo:hi])
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(out_mega, want_mega)
    if alias:
        with pytest.raises(ValueError, match="not both"):
            su3_matmul.su3_mult_planar(batch, bs, tile=64, alias=True, out=out)


@pytest.mark.cuda
def test_cuda_lattice_batches_over_the_card_twice_and_one_nccl_rank(cuda_device, tmp_path):
    """A batch of 5 lattices at L=8 and a 4-slot megakernel table, split in
    2 blocks (one launch each) on ``[card, card]`` and on one NCCL rank
    owning 2 slabs, equal the one-device runner bitwise; the service's
    megakernel mode on a host of 2 devices equals one device's."""
    from repro_torch.core.su3.plan import BatchedLatticeRunner, EngineConfig
    from repro_torch.launch import mesh as meshes
    from repro_torch.serve.su3 import ServiceConfig, SU3Service

    cfg = EngineConfig(L=8, tile=64)
    rng = np.random.default_rng(5)

    def su3(n):
        g = rng.standard_normal((n, 4, 3, 3)) + 1j * rng.standard_normal((n, 4, 3, 3))
        q, _ = np.linalg.qr(g)
        return torch.from_numpy(q.astype(np.complex64)).to(cuda_device)

    a, b = torch.stack([su3(8**4) for _ in range(5)]), su3(5)
    ks = torch.tensor([0, 1, 3, 4], dtype=torch.int32, device=cuda_device)
    one = BatchedLatticeRunner(cfg, cuda_device)
    table, table_b = one.pack_batch(a[:4]), one.pack_b_batch(b[:4])
    want = one.multiply(a, b, k=3)
    want_mega = one.plan.fused_batched_step(4, max_k=4)(table.clone(), table_b, ks)

    def check(runner):
        before = (su3_matmul.LAUNCHES.count, su3_matmul.MEGA_LAUNCHES.count)
        got = runner.multiply(a, b, k=3)
        mega = runner.plan.fused_batched_step(4, max_k=4)(table.clone(), table_b, ks)
        torch.cuda.synchronize()
        assert (su3_matmul.LAUNCHES.count - before[0],
                su3_matmul.MEGA_LAUNCHES.count - before[1]) == (2, 2)
        assert got.shape[0] == 5 and torch.equal(torch.view_as_real(got),
                                                 torch.view_as_real(want))
        assert torch.equal(mega, want_mega)

    check(BatchedLatticeRunner(cfg, meshes.MeshSpec(1, 2).resolve(
        devices=[cuda_device, cuda_device])))
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        check(BatchedLatticeRunner(cfg, meshes.MeshSpec(hosts=2).resolve()))
    finally:
        torch.distributed.destroy_process_group()

    def serve(device):
        svc = SU3Service(ServiceConfig(continuous=True, megakernel=True, autotune=False,
                                       tile=64, chain_slots=4), device=device)
        ids = [svc.submit(a[i], b[i], k=k) for i, k in enumerate([3, 1, 4, 2])]
        svc.run_until_drained()
        return [svc.pop_result(i) for i in ids]

    for x, y in zip(serve([cuda_device, cuda_device]), serve(cuda_device)):
        assert torch.equal(torch.view_as_real(x), torch.view_as_real(y))


def _family_at_kernel_heads(arch: str):
    """``arch``'s reduced config in bf16 at head dims a flash kernel of the
    main path serves: granite-moe at 64 (``flash_group_fwd<64>``,
    ``flash_bwd_d64``), deepseek-v3 at MLA's (192, 128) (``flash_mla_fwd``,
    the MLA backward)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    if cfg.use_mla:
        return mla.with_kernel_heads(cfg)
    return dataclasses.replace(cfg, d_head=64)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_cuda_mesh_families_train_and_serve_as_one_card(cuda_device, tmp_path, arch):
    """The MoE and MLA families on a (1, 1) mesh of one NCCL rank in bf16:
    2 train steps (experts through ``local_map``, the combine's partial sums
    reduced on the mesh) and a prefill + 4 greedy tokens through
    ``ServeEngine(..., mesh=)`` (the state at the reference's state rules),
    each with the one-card path's bits and its flash launches by kernel
    name."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.distributed import act_sharding, sharding
    from repro_torch.launch import mesh as meshes
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = _family_at_kernel_heads(arch)
    api = registry.get(cfg)
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    tree = common.init_params(api.spec(cfg), torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    runs = {}
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"))
        rules = sharding.default_rules(sharding.logical_mesh(mesh))
        for on_mesh in (False, True):
            if on_mesh:
                params = api.from_tree(cfg, sharding.distribute_tree(tree, api.spec(cfg), mesh,
                                                                     rules))
            else:
                params = api.from_tree(cfg, copy.deepcopy(tree)).to(cuda_device)
            params = common.trainable(params)
            state = adamw.init(params, opt)
            step = make_train_step(cfg, opt, q_chunk=64, kv_chunk=64)
            pipe, ps, losses = TokenPipeline(DataConfig(cfg.vocab_size, 256, 2, seed=1)), \
                PipelineState(), []
            fa.LAUNCHES_BY_KERNEL.clear()
            ctx = act_sharding.use_rules(mesh, rules) if on_mesh else contextlib.nullcontext()
            with ctx:
                for _ in range(2):
                    batch, ps = make_train_batch(pipe, ps, cfg, device=cuda_device)
                    if on_mesh:
                        batch = sharding.distribute_batch(batch, mesh, rules)
                    params, state, m = step(params, state, batch)
                    losses.append(float(m["loss"]))
            trained = dict(fa.LAUNCHES_BY_KERNEL)
            leaves = [p.detach().to_local() if on_mesh else p.detach()
                      for p in params.parameters()]
            for p in params.parameters():
                p.requires_grad_(False)
            engine = ServeEngine(cfg, params, ServeConfig(max_len=72), device=cuda_device,
                                 mesh=mesh if on_mesh else None)
            fa.LAUNCHES_BY_KERNEL.clear()
            tokens = engine.generate(prompts, 4)
            runs[on_mesh] = (losses, leaves, trained, tokens, dict(fa.LAUNCHES_BY_KERNEL))
    finally:
        torch.distributed.destroy_process_group()
    losses, leaves, trained, tokens, served = runs[True]
    assert losses == runs[False][0] and all(np.isfinite(losses))
    assert all(torch.equal(a, b) for a, b in zip(leaves, runs[False][1]))
    assert np.array_equal(tokens, runs[False][3])
    fwd = "flash_mla_fwd" if cfg.use_mla else "flash_group_fwd<64>"
    bwd = "flash_bwd_dq_mla" if cfg.use_mla else "flash_bwd_d64"
    mtp = 1 if cfg.mtp_depth else 0  # the MTP head's layer (not rematted)
    assert trained == runs[False][2] == {fwd: 2 * (2 * cfg.n_layers + mtp),
                                         bwd: 2 * (cfg.n_layers + mtp)}
    assert served == runs[False][4] == {fwd: cfg.n_layers}


def _state_family_at_kernel_heads(arch: str):
    """``arch``'s reduced config in bf16, its attention at D=64
    (``flash_group_fwd<64>``, ``flash_bwd_d64``: zamba2's shared block and
    Whisper's; xLSTM reaches no kernel)."""
    return dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16", d_head=64)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m", "whisper-tiny"])
def test_cuda_state_families_train_and_serve_as_one_card(cuda_device, tmp_path, arch):
    """Zamba2, xLSTM and Whisper on a (1, 1) mesh of one NCCL rank in bf16:
    2 train steps (Mamba2's conv and SSD, the xLSTM cells, Whisper's heads
    through ``local_map``) and a prefill + 4 greedy tokens through
    ``ServeEngine(..., mesh=)`` (the state at the reference's state rules),
    each with the one-card path's bits and its flash launches by kernel
    name: per train step one forward and one backward a shared-block
    application (zamba2: not rematted), the encoder's forwards once and the
    decoder's twice (remat) with one backward each (Whisper); in prefill
    one a shared application, one an encoder layer and two a decoder
    layer."""
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline
    from repro_torch.data.pipeline import make_train_batch
    from repro_torch.distributed import act_sharding, sharding
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import zamba
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    cfg = _state_family_at_kernel_heads(arch)
    api = registry.get(cfg)
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    tree = common.init_params(api.spec(cfg), torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    extras = None
    if cfg.is_encoder_decoder:
        extras = {"frames": np.random.default_rng(4).standard_normal(
            (2, cfg.encoder_len, cfg.d_model)).astype(np.float32)}
    runs = {}
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"))
        rules = sharding.default_rules(sharding.logical_mesh(mesh))
        for on_mesh in (False, True):
            if on_mesh:
                params = api.from_tree(cfg, sharding.distribute_tree(tree, api.spec(cfg), mesh,
                                                                     rules))
            else:
                params = api.from_tree(cfg, copy.deepcopy(tree)).to(cuda_device)
            params = common.trainable(params)
            state = adamw.init(params, opt)
            step = make_train_step(cfg, opt, q_chunk=64, kv_chunk=64)
            pipe, ps, losses = TokenPipeline(DataConfig(cfg.vocab_size, 256, 2, seed=1)), \
                PipelineState(), []
            fa.LAUNCHES_BY_KERNEL.clear()
            ctx = act_sharding.use_rules(mesh, rules) if on_mesh else contextlib.nullcontext()
            with ctx:
                for _ in range(2):
                    batch, ps = make_train_batch(pipe, ps, cfg, device=cuda_device)
                    if on_mesh:
                        batch = sharding.distribute_batch(batch, mesh, rules)
                    params, state, m = step(params, state, batch)
                    losses.append(float(m["loss"]))
            trained = dict(fa.LAUNCHES_BY_KERNEL)
            leaves = [p.detach().to_local() if on_mesh else p.detach()
                      for p in params.parameters()]
            for p in params.parameters():
                p.requires_grad_(False)
            engine = ServeEngine(cfg, params, ServeConfig(max_len=72), device=cuda_device,
                                 mesh=mesh if on_mesh else None)
            fa.LAUNCHES_BY_KERNEL.clear()
            tokens = engine.generate(prompts, 4, extras)
            runs[on_mesh] = (losses, leaves, trained, tokens, dict(fa.LAUNCHES_BY_KERNEL))
    finally:
        torch.distributed.destroy_process_group()
    losses, leaves, trained, tokens, served = runs[True]
    assert losses == runs[False][0] and all(np.isfinite(losses))
    assert all(torch.equal(a, b) for a, b in zip(leaves, runs[False][1]))
    assert np.array_equal(tokens, runs[False][3])
    fwd, bwd = "flash_group_fwd<64>", "flash_bwd_d64"
    if cfg.hybrid_attn_every:
        groups = zamba._counts(cfg)[0]
        per_step, prefill = {fwd: groups, bwd: groups}, {fwd: groups}
    elif cfg.is_encoder_decoder:
        n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
        per_step = {fwd: n_enc + 4 * n_dec, bwd: n_enc + 2 * n_dec}
        prefill = {fwd: n_enc + 2 * n_dec}
    else:
        per_step, prefill = {}, {}
    assert trained == runs[False][2] == {k: 2 * n for k, n in per_step.items()}
    assert served == runs[False][4] == prefill


@pytest.mark.cuda
def test_cuda_seq_sharded_latents_serve_as_one_card(cuda_device, tmp_path):
    """deepseek-v3 reduced at MLA's kernel heads in bf16 served on a (1, 1)
    NCCL mesh with ``kv_seq_shard=True``: its latents split along their
    sequence (one part), the absorbed decode through the partial softmax
    and its combine; the greedy tokens the one card's, the prefill's flash
    launches the one card's."""
    from repro_torch.launch import mesh as meshes

    cfg = _family_at_kernel_heads("deepseek-v3-671b")
    api = registry.get(cfg)
    tree = common.init_params(api.spec(cfg), torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    runs = {}
    meshes.init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"))
        for on_mesh in (False, True):
            params = api.from_tree(cfg, copy.deepcopy(tree)).to(cuda_device, torch.bfloat16)
            engine = ServeEngine(cfg, params, ServeConfig(max_len=72), device=cuda_device,
                                 mesh=mesh if on_mesh else None, kv_seq_shard=on_mesh)
            fa.LAUNCHES_BY_KERNEL.clear()
            tokens = engine.generate(prompts, 4)
            runs[on_mesh] = (tokens, dict(fa.LAUNCHES_BY_KERNEL))
    finally:
        torch.distributed.destroy_process_group()
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1] == {"flash_mla_fwd": cfg.n_layers}
