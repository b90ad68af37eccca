"""The PyTorch port's layout codec against the JAX reference.

Pack, unpack and the planar view only move data, so they must equal the
reference bit for bit over AOS/SOA/AOSOA x f32/bf16 x none/two-row (AOS has
no two-row form).  The rebuilt third row of two-row storage is arithmetic;
it is held to 1 ulp of its operands' scale, because XLA may contract a
product and a difference into one FMA where the port rounds each op.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.su3 import layouts as jl
from repro_torch.core.su3 import layouts as tl


def _canonical(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_sites, 4, 3, 3, 2)).astype(np.float32)
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


def _su3(n_sites: int, seed: int) -> np.ndarray:
    """Random SU(3) links (n_sites, 4, 3, 3) complex64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def _bits(x) -> np.ndarray:
    """Raw bits of a jax array or torch tensor (bf16 -> uint16, f32/c64 -> uint32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.uint16)
        if x.is_complex():
            x = torch.view_as_real(x.contiguous())
        return x.contiguous().numpy().view(np.uint32)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    if np.iscomplexobj(arr):
        arr = np.stack([arr.real, arr.imag], axis=-1)
    return np.ascontiguousarray(arr).view(np.uint32)


CASES = [
    (layout, dtype, comp)
    for layout in ("aos", "soa", "aosoa")
    for dtype in ("float32", "bfloat16")
    for comp in ("none", "two_row")
    if not (layout == "aos" and comp == "two_row")
]


@pytest.mark.parametrize("layout,dtype,comp", CASES)
def test_pack_unpack_planar_view_bitwise_vs_reference(layout, dtype, comp):
    n_sites, tile = 81, 16  # 81 does not divide the tile: AoSoA pads
    a = _su3(n_sites, 3) if comp == "two_row" else _canonical(n_sites, 3)
    jc = jl.make_codec(jl.Layout(layout), tile=tile, dtype=dtype, compression=comp)
    tc = tl.make_codec(tl.Layout(layout), tile=tile, dtype=dtype, compression=comp)

    jp, tp = jc.pack(jnp.asarray(a)), tc.pack(torch.from_numpy(a))
    assert tuple(tp.shape) == tuple(jp.shape) == tc.phys_shape(n_sites)
    assert tp.dtype == tc.word_dtype
    np.testing.assert_array_equal(_bits(tp), _bits(jp))

    ju, tu = jc.unpack(jp, n_sites), tc.unpack(tp, n_sites)
    assert tuple(tu.shape) == tuple(ju.shape) == a.shape and tu.dtype == torch.complex64
    if comp == "none":
        np.testing.assert_array_equal(_bits(tu), _bits(ju))
    else:  # stored rows move bits; row 2 is rebuilt arithmetic
        np.testing.assert_array_equal(_bits(tu[:, :, :2]), _bits(ju[:, :, :2]))
        np.testing.assert_allclose(tu[:, :, 2].numpy(), np.asarray(ju[:, :, 2]),
                                   rtol=0, atol=np.spacing(np.float32(1.0)))

    jb = jc.pack_b(jnp.asarray(a[0]))
    tb = tc.pack_b(torch.from_numpy(a[0]))
    np.testing.assert_array_equal(_bits(tb), _bits(jb))
    np.testing.assert_array_equal(_bits(tc.unpack_b(tb)), _bits(jc.unpack_b(jb)))

    if layout != "aos":
        jv, tv = jc.planar_view(jp), tc.planar_view(tp)
        s_phys = tp.shape[-1] if layout == "soa" else tp.shape[0] * tile
        assert tuple(tv.shape) == (2, tc.planar_rows, s_phys)
        np.testing.assert_array_equal(_bits(tv), _bits(jv))
        np.testing.assert_array_equal(_bits(tc.from_planar_view(tv, tp)), _bits(tp))
    else:
        with pytest.raises(ValueError, match="no planar kernel view"):
            tc.planar_view(tp)


def test_aos_metadata_words_and_unpack_drop_them():
    a = _canonical(10, 4)
    codec = tl.make_codec(tl.Layout.AOS)
    phys = codec.pack(torch.from_numpy(a))
    assert tuple(phys.shape) == (10, tl.SITE_WORDS_AOS)
    assert torch.equal(phys[:, tl.GAUGE_WORDS], torch.arange(10, dtype=torch.float32))
    assert torch.equal(phys[:, tl.GAUGE_WORDS + 5], torch.arange(10, dtype=torch.float32) % 2)
    assert torch.equal(codec.unpack(phys, 10), torch.from_numpy(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_third_row_within_one_ulp(seed):
    u = _su3(64, seed)
    r0, r1 = u[:, :, 0, :], u[:, :, 1, :]
    j = np.asarray(jl.reconstruct_third_row(jnp.asarray(r0), jnp.asarray(r1)))
    t = tl.reconstruct_third_row(torch.from_numpy(r0), torch.from_numpy(r1)).numpy()
    # operands are SU(3) entries (|x| <= 1): one ulp of the products' scale
    ulp = np.spacing(np.float32(1.0))
    assert np.max(np.abs(t.real - j.real)) <= ulp
    assert np.max(np.abs(t.imag - j.imag)) <= ulp
    # and it is the unitarity row: conj(r0 x r1) equals row 2 of the SU(3) link
    assert np.max(np.abs(t - u[:, :, 2, :])) < 1e-5


def test_aosoa_padding_zero_fills_and_slices():
    codec = tl.make_codec(tl.Layout.AOSOA, tile=128)
    a = torch.from_numpy(_canonical(7, 5))
    phys = codec.pack(a)
    assert tuple(phys.shape) == (1, 2, tl.PLANAR_ROWS, 128)
    full = codec.unpack(phys)
    assert full.shape[0] == 128 and bool(torch.all(full[7:] == 0))
    assert torch.equal(codec.unpack(phys, 7), a)


def test_compression_rejected_for_aos_like_reference():
    with pytest.raises(ValueError, match="only defined for SOA/AoSoA"):
        tl.make_codec(tl.Layout.AOS, compression="two_row")
    with pytest.raises(ValueError, match="only defined for SOA/AoSoA"):
        jl.make_codec(jl.Layout.AOS, compression="two_row")


@pytest.mark.parametrize("layout", ["aos", "soa", "aosoa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("comp", ["none", "two_row"])
def test_traffic_model_fields_equal_reference(layout, dtype, comp):
    j = jl.TrafficModel.for_dtype(jl.Layout(layout), 1000, dtype, comp)
    t = tl.TrafficModel.for_dtype(tl.Layout(layout), 1000, dtype, comp)
    for f in ("words_per_site", "bytes_per_site_rw", "total_bytes", "flops_per_site",
              "arithmetic_intensity"):
        assert getattr(t, f) == getattr(j, f), f
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_constants_and_paper_intensity_equal_reference():
    for name in ("LINKS", "SU3", "GAUGE_WORDS", "SITE_PAD_WORDS", "SITE_WORDS_AOS", "LANE",
                 "PLANAR_ROWS", "PLANAR_COMP_ROWS", "GAUGE_COMP_WORDS", "COMP_ROW_INDICES",
                 "WORD_BYTES"):
        assert getattr(tl, name) == getattr(jl, name), name
    for wb in (4, 8):
        assert tl.paper_arithmetic_intensity(wb) == jl.paper_arithmetic_intensity(wb)
    assert tl.LatticeShape(3).padded_sites(16) == jl.LatticeShape(3).padded_sites(16) == 96
