"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA device (marker ``cuda``) and skip without one.
The file imports torch and the port only, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.core.su3.plan import verify_tolerance
from repro_torch.kernels import ops, su3_matmul

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
