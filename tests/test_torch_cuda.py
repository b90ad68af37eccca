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
