"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA device (marker ``cuda``) and skip without one.
The file imports torch and the port only, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.core.su3.plan import verify_tolerance
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, su3_matmul
from repro_torch.models import registry
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
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(*(t.to(cuda_device, torch.float16) for t in (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,threads", [(torch.bfloat16, 384), (torch.float32, 256)])
def test_cuda_flash_attention_shared_memory_budget(cuda_device, dtype, threads):
    """Each body's real budget: within 227 KB a block, no spills, one block
    per SM or more (the bf16 body holds one: 230,448 bytes at D=128, Q and
    three stages of K and V, and three warpgroups), and the tiling the
    Python side assumes (kernel_budget raises otherwise)."""
    for d in fa.HEAD_DIMS:
        for causal in (True, False):
            budget = fa.kernel_budget(dtype, d, causal=causal)
            assert budget["shared_bytes"] == fa.smem_bytes(d, dtype) <= 232448
            assert budget["threads_per_block"] == threads
            assert budget["local_bytes"] == 0 and budget["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "granite-moe-1b-a400m"])
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


# -- the flash backward -------------------------------------------------------------

BWD_SHAPES = [  # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset)
    (2, 1024, 1024, 32, 8, 128, True, 0),  # the training shape (qwen3-4b)
    (1, 100, 100, 4, 1, 64, True, 0),  # ragged, G=4
    (1, 100, 100, 4, 4, 32, False, 0),  # ragged, G=1, non-causal
    (2, 64, 200, 8, 2, 64, True, 136),  # Sq < Skv, queries continuing a prefix
    (1, 64, 200, 4, 4, 32, False, 0),  # Sq < Skv, non-causal
    (1, 130, 130, 8, 2, 128, True, 0),  # a ragged second tile at D=128
    (1, 77, 77, 12, 4, 128, True, 0),  # G=3: Sq * G = 231, no multiple of any row tile
    (2, 1024, 1024, 16, 8, 64, True, 0),  # granite-moe-1b's training shape: D=64, G=2
]


def _bwd_inputs(shape, dtype, device, seed):
    """q, k, v, dout on the card (bf16 or f32) and the forward's out, lse."""
    b, sq, skv, hq, hkv, d, causal, q_offset = shape
    q, k, v = (t.to(device) for t in _qkv(shape, dtype, seed))
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, sq, hq, d), dtype=np.float32)).to(device, dtype)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_is_deterministic(cuda_device, dtype):
    shape = BWD_SHAPES[0]
    q, k, v, dout, out, lse = _bwd_inputs(shape, dtype, cuda_device, seed=61)
    first = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    again = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_forward_with_lse_keeps_out(cuda_device, dtype):
    """out is the same bits with and without lse; lse against the plain
    version's within 1e-5 (f32 sums in another order)."""
    for shape in BWD_SHAPES[1:]:
        b, sq, skv, hq, hkv, d, causal, q_offset = shape
        q, k, v = (t.to(cuda_device) for t in _qkv(shape, dtype, seed=62))
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
    by the wrapper).  The gradients are those of contiguous copies."""
    shape = (2, 200, 200, 8, 2, 128, True, 0)
    q, k, v, dout, out, lse = _bwd_inputs(shape, torch.bfloat16, cuda_device, seed=64)
    d = dout.shape[-1]
    out_t = out.transpose(1, 2).contiguous().transpose(1, 2)
    aligned = torch.zeros((*dout.shape[:3], 2 * d), dtype=dout.dtype, device=cuda_device)
    aligned[..., :d] = dout
    offset = torch.zeros((*dout.shape[:3], 2 * d), dtype=dout.dtype, device=cuda_device)
    offset[..., 1:d + 1] = dout
    assert not out_t.is_contiguous() and fa._rows_aligned(aligned[..., :d])
    assert not fa._rows_aligned(offset[..., 1:d + 1])
    want = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    in_place = fa.flash_attention_bwd(q, k, v, out_t, aligned[..., :d], lse)
    copied = fa.flash_attention_bwd(q, k, v, out_t, offset[..., 1:d + 1], lse)
    torch.cuda.synchronize()
    for g, h, w in zip(in_place, copied, want):
        assert torch.equal(g, w) and torch.equal(h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,threads", [(torch.float32, 256), (torch.bfloat16, 384)])
def test_cuda_flash_backward_budget(cuda_device, dtype, threads):
    """Within 227 KB a block, no spills, at least one block per SM, and the
    tiling the Python side assumes (bwd_budget raises otherwise).  The bf16
    kernels are warp-specialised: 168 registers a thread at launch, the pool
    that setmaxnreg hands from the producer to the consumers."""
    for d in fa.HEAD_DIMS:
        for causal in (True, False):
            budget = fa.bwd_budget(dtype, d, causal=causal)
            for name, smem in zip(("dkdv", "dq"), fa.bwd_smem_bytes(d, dtype)):
                assert budget[name]["shared_bytes"] == smem <= 232448
                assert budget[name]["local_bytes"] == 0 and budget[name]["blocks_per_sm"] >= 1
                assert budget[name]["threads_per_block"] == threads
                if dtype == torch.bfloat16:
                    assert budget[name]["num_regs"] == 168


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
