"""The paper's five SU3_Bench variants in the PyTorch port against the JAX
reference's XLA variants, on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.su3 import variants as jvariants
from repro.kernels import ref as jref
from repro_torch.core.su3 import registry, variants
from repro_torch.kernels import ops  # noqa: F401  (registers the CUDA kernel)
from repro_torch.kernels import ref

VARIANTS = ["version0", "version3", "versionX", "version_gemm", "version_blocked"]


def _canonical(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_sites, 4, 3, 3, 2)).astype(np.float32)
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("n_sites", [64, 130])  # 130: version_blocked pads the lane
def test_variant_matches_reference(name, n_sites):
    a, b = _canonical(n_sites, 1), _canonical(1, 2)[0]
    want = np.asarray(jvariants.get_variant(name)(jnp.asarray(a), jnp.asarray(b)))
    got = variants.get_variant(name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == a.shape and got.dtype == torch.complex64
    # |C| entries are sums of 3 products of N(0, 2) complex numbers
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = np.einsum("sjkl,jlm->sjkm", a.astype(np.complex128), b.astype(np.complex128))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_blocked_variant_lane_argument():
    a, b = _canonical(40, 3), _canonical(1, 4)[0]
    want = np.asarray(jvariants.version_blocked(jnp.asarray(a), jnp.asarray(b), lane=16))
    got = variants.version_blocked(torch.from_numpy(a), torch.from_numpy(b), lane=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_oracles_match_reference():
    a, b = _canonical(32, 5), _canonical(1, 6)[0]
    np.testing.assert_allclose(
        ref.su3_mult_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jref.su3_mult_ref(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    a_p = np.stack([a.real, a.imag]).transpose(0, 2, 3, 4, 1)  # (2, 4, 3, 3, S)
    b_p = np.stack([b.real, b.imag])
    np.testing.assert_allclose(
        ref.su3_mult_planar_ref(torch.from_numpy(a_p), torch.from_numpy(b_p)).numpy(),
        np.asarray(jref.su3_mult_planar_ref(jnp.asarray(a_p), jnp.asarray(b_p))),
        rtol=1e-5, atol=1e-5)


def test_variant_registry_matches_reference():
    assert variants.variant_names() == jvariants.variant_names() == sorted(VARIANTS)
    for name in VARIANTS:
        entry = registry.get_kernel(name)
        assert entry.form == registry.CANONICAL and entry.backends == ("torch",)
        assert entry.supports_accum_dtype() and entry.supports_compression()
    assert registry.kernel_names(backend="cuda") == [
        "cuda", "cuda_cg", "cuda_megakernel", "cuda_stencil"]
    with pytest.raises(KeyError, match="not a canonical"):
        variants.get_variant("cuda")
