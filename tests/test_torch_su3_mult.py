"""The planar SU3 multiply: the port's plain version against the JAX Pallas
kernel (interpret mode on the CPU).  The CUDA kernel is held against the
plain version on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.

Inputs are random SU(3) links made with numpy from a seed; the uniform
su3_bench lattice would hide a site permutation.  Tolerance is the
reference's ``plan.verify_tolerance``: 1e-5 for f32 storage, 1e-2 for bf16
storage.  XLA contracts FMAs, so at f32 the frameworks agree to within
it, not bitwise; pure bf16 rounds after every operation on both sides and
agrees bit for bit.  Inside the port a k-chain equals k single steps bit
for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.su3 import registry as jregistry
from repro.core.su3.plan import verify_tolerance
from repro.kernels import ops as jops
from repro_torch.core.su3 import registry
from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.kernels import _build, ops, su3_matmul

S = 256  # sites: one tile


def _su3(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)


def _planar(c: np.ndarray) -> np.ndarray:
    """(n, 4, 3, 3) complex -> planar (2, 36, n) f64."""
    return np.stack([c.real, c.imag]).transpose(0, 2, 3, 4, 1).reshape(2, 36, c.shape[0])


def _inputs(dtype: str, compressed: bool, seed: int = 0):
    """The same words for both frameworks: jax arrays, and torch tensors made
    from their f32 values (exact for bf16)."""
    a = _planar(_su3(S, seed))
    if compressed:
        a = a[:, list(COMP_ROW_INDICES)]
    b = _planar(_su3(1, seed + 1))[..., 0]
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    tdt = getattr(torch, dtype)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tdt)
    return ja, jb, ta, tb


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


FORMS = [  # (storage dtype, accum dtype, two-row)
    ("float32", None, False),
    ("bfloat16", "float32", False),
    ("float32", None, True),
    ("bfloat16", "float32", True),
]


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
def test_plain_version_matches_pallas_kernel(dtype, accum, compressed, k):
    ja, jb, ta, tb = _inputs(dtype, compressed)
    want = jops.su3_mult_planar(ja, jb, tile=S, k_iters=k, accum_dtype=accum,
                                compressed=compressed)
    got = ops.su3_mult_planar(ta, tb, tile=S, k_iters=k, accum_dtype=accum,
                              compressed=compressed)
    assert got.dtype == ta.dtype and tuple(got.shape) == tuple(want.shape)
    err = np.max(np.abs(_f32(got) - _f32(want)))
    assert err <= verify_tolerance(dtype, accum or "", compressed), err


def _bits(x) -> np.ndarray:
    """The stored bf16 words as uint16, from either framework."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("k", [1, 3, 9])
def test_pure_bf16_chain_vs_pallas_kernel(k):
    """Pure bf16 storage: every product, sum and difference rounds to bf16,
    in the port as in the reference's bf16 ``_mult_tile``, so the chain
    equals the Pallas kernel bit for bit."""
    ja, jb, ta, tb = _inputs("bfloat16", False)
    want = jops.su3_mult_planar(ja, jb, tile=S, k_iters=k)
    got = ops.su3_mult_planar(ta, tb, tile=S, k_iters=k)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,accum,compressed", FORMS + [("bfloat16", None, False)])
def test_k_chain_equals_k_single_steps(dtype, accum, compressed):
    """Bitwise at f32 and at pure bf16 (each step stores what the chain
    carries); bf16 storage with f32 accumulation rounds once per launch, so
    only its k=1 matches."""
    _, _, ta, tb = _inputs(dtype, compressed, seed=4)
    k = 5
    chained = ops.su3_mult_planar(ta, tb, tile=S, k_iters=k, accum_dtype=accum,
                                  compressed=compressed)
    x = ta
    for _ in range(k):
        x = ops.su3_mult_planar(x, tb, tile=S, accum_dtype=accum, compressed=compressed)
    if accum == "float32":
        x32 = ta
        for _ in range(k):  # the f32 chain, narrowed once
            x32 = su3_matmul.su3_mult_planar_plain(x32.float(), tb.float(), compressed=compressed)
        assert torch.equal(chained, x32.to(ta.dtype))
    else:
        assert torch.equal(chained, x)


def test_aosoa_and_alias_paths_equal_soa():
    _, _, ta, tb = _inputs("float32", False, seed=2)
    soa = ops.su3_mult_planar(ta, tb, tile=64, k_iters=2)
    tiled = torch.movedim(ta.reshape(2, 36, S // 64, 64), 2, 0).contiguous()
    out = ops.su3_mult_planar(tiled, tb, tile=64, k_iters=2)
    assert torch.equal(torch.movedim(out, 0, 2).reshape(2, 36, S), soa)
    a2 = ta.clone()
    assert ops.su3_mult_planar(a2, tb, tile=64, k_iters=2, alias=True) is a2
    assert torch.equal(a2, soa)


def test_canonical_su3_mult_matches_reference():
    a = _su3(100, 6).astype(np.complex64)  # 100 sites: pads to the tile
    b = _su3(1, 7)[0].astype(np.complex64)
    want = np.asarray(jops.su3_mult(jnp.asarray(a), jnp.asarray(b), tile=64))
    got = ops.su3_mult(torch.from_numpy(a), torch.from_numpy(b), tile=64)
    assert got.shape == a.shape and got.dtype == torch.complex64
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5
    ref = ops.su3_mult_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.max(torch.abs(got - ref)).item() <= 1e-5


def test_wrapper_rejects_bad_arguments_and_devices():
    _, _, ta, tb = _inputs("float32", False)
    before = su3_matmul.LAUNCHES.count
    ops.su3_mult_planar(ta, tb, tile=S)  # a CPU tensor runs the plain version
    with pytest.raises(ValueError, match="must be"):
        ops.su3_mult_planar(ta[:, :24], tb, tile=S)
    with pytest.raises(ValueError, match="b must be"):
        ops.su3_mult_planar(ta, tb[:, :24], tile=S)
    with pytest.raises(ValueError, match="multiple of tile"):
        ops.su3_mult_planar(ta, tb, tile=96)
    with pytest.raises(ValueError, match="k_iters"):
        ops.su3_mult_planar(ta, tb, tile=S, k_iters=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.su3_mult_planar(ta.double(), tb.double(), tile=S)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.su3_mult_planar(ta.to("meta"), tb.to("meta"), tile=S)
    assert su3_matmul.LAUNCHES.count == before  # nothing here reached the kernel


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("su3_mult", build_dir=tmp_path / "build")


def test_registry_maps_reference_names_and_flags():
    entry, ref = registry.get_kernel("pallas"), jregistry.get_kernel("pallas")
    assert entry is registry.get_kernel("cuda") and entry.backends == ("cuda",)
    assert entry.form == ref.form == registry.PLANAR
    assert [l.value for l in entry.layouts] == [l.value for l in ref.layouts]
    for flag in ("supports_fused", "supports_accum", "supports_compressed"):
        assert getattr(entry, flag) == getattr(ref, flag), flag
    with pytest.raises(KeyError, match="unknown SU3 kernel"):
        registry.get_kernel("nope")
    with pytest.raises(ValueError, match="unknown kernel form"):
        registry.register_kernel("x", form="nope")
