"""The stencil slice of the port against the JAX reference, on the CPU.

The same numpy inputs go through both packages: the neighbour tables and
the halo geometry (integers: equal), the vector codec (data movement:
bitwise), the stencil's plain version against the Pallas kernel in
interpret mode, and ``ExecutionPlan.stencil_step`` against the reference
plan's.  Tolerances are the reference's ``verify_tolerance``: at f32 XLA
contracts FMAs, so the frameworks agree within 1e-5, not bitwise; pure bf16
rounds after every operation on both sides and agrees bit for bit; bf16
storage with f32 accumulation stays within 1e-2.  Inside the port the
reference's bitwise contracts hold bitwise: AoSoA against SoA, a site
subset against the full pass, overlap and depth-2 against the serial path.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.su3 import layouts as jl
from repro.core.su3 import plan as jplan
from repro.core.su3 import registry as jregistry
from repro.distributed import sharding as jsharding
from repro.kernels import ops as jops
from repro.kernels import su3_stencil as jstencil
from repro_torch.core import roofline
from repro_torch.core.su3 import layouts as tl
from repro_torch.core.su3 import plan as tplan
from repro_torch.core.su3 import registry as tregistry
from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import ops, su3_stencil

S = 256  # sites: one tile


def _su3(n_sites: int, seed: int) -> np.ndarray:
    """Random SU(3) links (n_sites, 4, 3, 3) complex64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def _planar_links(n_sites: int, seed: int, compressed: bool) -> np.ndarray:
    c = _su3(n_sites, seed)
    a = np.stack([c.real, c.imag]).transpose(0, 2, 3, 4, 1).reshape(2, 36, n_sites)
    return a[:, list(COMP_ROW_INDICES)] if compressed else a


def _pair(x: np.ndarray, dtype: str):
    """The same words for both frameworks (bf16 rounded once, by jax)."""
    j = jnp.asarray(x, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


# -- geometry ------------------------------------------------------------------------


@pytest.mark.parametrize("L,n_shards", [(2, 1), (2, 2), (2, 4), (3, 1), (4, 1), (4, 2), (4, 4)])
def test_neighbor_tables_equal_reference(L, n_shards):
    padded = L**4 + 13  # padding sites point at themselves
    want = jplan.stencil_neighbor_tables(L, padded, n_shards)
    got = tplan.stencil_neighbor_tables(L, padded, n_shards)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_neighbor_tables_reject_uneven_slabs():
    with pytest.raises(ValueError, match="does not shard over 2 slabs"):
        tplan.stencil_neighbor_tables(3, 81, 2)


@pytest.mark.parametrize("L,n_shards,depth", [(2, 1, 1), (2, 2, 1), (2, 4, 2), (4, 2, 1),
                                              (4, 2, 2), (4, 4, 1), (4, 8, 2), (3, 3, 1)])
def test_halo_spec_equals_reference(L, n_shards, depth):
    kw = dict(L=L, n_shards=n_shards, word_bytes=2, words_per_site=6, depth=depth)
    j, t = jsharding.HaloSpec(**kw), tsharding.HaloSpec(**kw)
    for name in ("sites_per_shard", "face_sites", "boundary_sites", "halo_sites",
                 "interior_fraction", "halo_bytes_per_exchange"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.as_dict() == j.as_dict()
    for shard in range(n_shards):
        for name in ("shard_range", "boundary_ranges", "interior_ranges", "ghost_ranges"):
            assert getattr(t, name)(shard) == getattr(j, name)(shard), (name, shard)
    with pytest.raises(ValueError, match="out of range"):
        t.shard_range(n_shards)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_halo_spec_function_matches_reference(hosts):
    # the reference reads only the mesh's host-axis size
    mesh = types.SimpleNamespace(axis_names=("hosts", "devices"),
                                 shape={"hosts": hosts, "devices": 1})
    for kw in ({}, {"dtype": "bfloat16"}, {"words_per_site": tsharding.VECTOR_WORDS_PER_SITE,
                                            "depth": 2}):
        assert dataclasses.astuple(tsharding.halo_spec(4, hosts, **kw)) == dataclasses.astuple(
            jsharding.halo_spec(4, mesh, **kw))
    with pytest.raises(ValueError, match="contradicts"):
        tsharding.halo_spec(4, 1, 4, dtype="bfloat16")
    with pytest.raises(ValueError, match="does not shard over 3 hosts"):
        tsharding.halo_spec(4, 3)
    assert tsharding.VECTOR_WORDS_PER_SITE == jsharding.VECTOR_WORDS_PER_SITE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vec_codec_matches_reference_bitwise(dtype):
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((81, 3)) + 1j * rng.standard_normal((81, 3))).astype(np.complex64)
    jc = jl.make_codec(jl.Layout.SOA, tile=64, dtype=dtype)
    tc = tl.make_codec(tl.Layout.AOSOA, tile=64, dtype=dtype)  # one form in every layout
    want = jc.pack_vec(jnp.asarray(v), 128)
    got = tc.pack_vec(torch.from_numpy(v), 128)
    assert tuple(got.shape) == (2, 3, 128) and got.dtype == tc.word_dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(tc.unpack_vec(got, 81).numpy(),
                                  np.asarray(jc.unpack_vec(want, 81)))


# -- the kernel's plain version against the Pallas kernel ----------------------------


FORMS = [  # (storage dtype, accum dtype, two-row)
    ("float32", None, False),
    ("bfloat16", "float32", False),
    ("bfloat16", None, False),
    ("float32", None, True),
    ("bfloat16", None, True),
    ("bfloat16", "float32", True),
]


@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
def test_plain_stencil_matches_pallas_kernel(dtype, accum, compressed):
    ju, tu = _pair(_planar_links(S, 0, compressed), dtype)
    jv, tv = _pair(np.random.default_rng(1).standard_normal((8, 2, 3, S)), dtype)
    want = jops.su3_stencil_planar(ju, jv, tile=S, accum_dtype=accum, compressed=compressed)
    got = ops.su3_stencil_planar(tu, tv, tile=S, accum_dtype=accum, compressed=compressed)
    assert got.dtype == tu.dtype and tuple(got.shape) == (2, 3, S)
    if dtype == "bfloat16" and accum is None:  # every op rounds to bf16 on both sides
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        err = np.max(np.abs(_np(got) - _np(want)))
        assert err <= jplan.verify_tolerance(dtype, accum or "", compressed), err


@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
def test_aosoa_links_equal_soa_bitwise(dtype, accum, compressed):
    _, tu = _pair(_planar_links(S, 2, compressed), dtype)
    _, tv = _pair(np.random.default_rng(3).standard_normal((8, 2, 3, S)), dtype)
    kw = {"tile": 64, "accum_dtype": accum, "compressed": compressed}
    tiled = torch.movedim(tu.reshape(2, tu.shape[1], S // 64, 64), 2, 0).contiguous()
    np.testing.assert_array_equal(_bits(ops.su3_stencil_planar(tiled, tv, **kw)),
                                  _bits(ops.su3_stencil_planar(tu, tv, **kw)))


@pytest.mark.parametrize("compressed", [False, True])
def test_site_subset_equals_full_pass_bitwise(compressed):
    _, tu = _pair(_planar_links(S, 4, compressed), "float32")
    _, tv = _pair(np.random.default_rng(5).standard_normal((8, 2, 3, S)), "float32")
    full = ops.su3_stencil_planar(tu, tv, tile=64, compressed=compressed)
    idx = torch.from_numpy(np.random.default_rng(6).permutation(S)[:128])
    sub = ops.su3_stencil_planar(tu[:, :, idx], tv[..., idx], tile=64, compressed=compressed)
    np.testing.assert_array_equal(_bits(sub), _bits(full[:, :, idx]))


def test_stencil_wrapper_rejects_bad_arguments():
    _, tu = _pair(_planar_links(S, 0, False), "float32")
    _, tv = _pair(np.zeros((8, 2, 3, S)), "float32")
    before = su3_stencil.STENCIL_LAUNCHES.count
    with pytest.raises(ValueError, match="u must be"):
        ops.su3_stencil_planar(tu[:, :24], tv, tile=S)
    with pytest.raises(ValueError, match="multiple of tile"):
        ops.su3_stencil_planar(tu, tv, tile=96)
    with pytest.raises(ValueError, match="v_nbr must be"):
        ops.su3_stencil_planar(tu, tv[:4], tile=S)
    with pytest.raises(ValueError, match="match u's device and dtype"):
        ops.su3_stencil_planar(tu, tv.double(), tile=S)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.su3_stencil_planar(tu.double(), tv.double(), tile=S)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.su3_stencil_planar(tu.to("meta"), tv.to("meta"), tile=S)
    assert su3_stencil.STENCIL_LAUNCHES.count == before  # the CPU never reaches the kernel


def test_registry_entries_and_constants_match_reference():
    for ref_name, port_name in (("pallas_stencil", "cuda_stencil"), ("pallas_cg", "cuda_cg")):
        entry, ref = tregistry.get_kernel(ref_name), jregistry.get_kernel(ref_name)
        assert entry is tregistry.get_kernel(port_name) and entry.backends == ("cuda",)
        assert entry.form == ref.form
        assert [l.value for l in entry.layouts] == [l.value for l in ref.layouts]
        for flag in ("supports_fused", "supports_accum", "supports_compressed"):
            assert getattr(entry, flag) == getattr(ref, flag), flag
    for name in ("STENCIL_FLOPS_PER_SITE", "STENCIL_WORDS_PER_SITE",
                 "STENCIL_COMP_WORDS_PER_SITE", "CG_COEFS", "CG_ITER_FLOPS_PER_SITE",
                 "CG_EXTRA_WORDS_PER_SITE"):
        assert getattr(su3_stencil, name) == getattr(jstencil, name), name
    assert (tplan.CG_SHIFT, tplan.CG_DIVERGENCE_FACTOR) == (jplan.CG_SHIFT,
                                                            jplan.CG_DIVERGENCE_FACTOR)
    assert tregistry.REFERENCE_NAMES[jplan.STENCIL_VARIANT] == tplan.STENCIL_VARIANT
    assert tregistry.REFERENCE_NAMES[jplan.CG_VARIANT] == tplan.CG_VARIANT


# -- the plan's stencil step ------------------------------------------------------------


def _plans(L: int, layout: str, dtype: str, accum: str, comp: str, tile: int = 64):
    fields = dict(L=L, dtype=dtype, accum_dtype=accum, compression=comp, tile=tile,
                  iterations=1, warmups=0)
    jp = jplan.build_plan(jplan.EngineConfig(layout=jl.Layout(layout), **fields))
    tp = tplan.build_plan(tplan.EngineConfig(layout=tl.Layout(layout), variant="pallas",
                                             **fields), device="cpu")
    return jp, tp


def _field(L: int, seed: int):
    rng = np.random.default_rng(seed)
    n = L**4
    return _su3(n, seed), (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
                           ).astype(np.complex64)


@pytest.mark.parametrize("layout", ["soa", "aosoa"])
@pytest.mark.parametrize("dtype,accum", [("float32", ""), ("bfloat16", "float32")])
@pytest.mark.parametrize("comp", ["none", "two_row"])
def test_stencil_step_matches_reference_plan(layout, dtype, accum, comp):
    jp, tp = _plans(4, layout, dtype, accum, comp)
    u, v = _field(4, 7)
    ju, jv = jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(v))
    tu = tp.pack_gauge(u)  # canonical numpy into both packages' pack_gauge
    np.testing.assert_array_equal(_bits(tu), _bits(ju))
    (tv,) = tplan.vectors_from_reference(tp, np.asarray(jv))
    want, got = jp.stencil_step()(ju, jv), tp.stencil_step()(tu, tv)
    assert got.dtype == tp.codec.word_dtype and tuple(got.shape) == (2, 3, tp.padded_sites)
    err = np.max(np.abs(_np(got) - _np(want)))
    assert err <= jplan.verify_tolerance(dtype, accum, comp == "two_row"), err


@pytest.mark.parametrize("comp", ["none", "two_row"])
@pytest.mark.parametrize("layout", ["soa", "aosoa"])
def test_verify_stencil_holds_at_both_fixed_points(comp, layout):
    _, tp = _plans(4, layout, "float32", "", comp)
    u, v = tp.init_stencil_data()
    out = tp.stencil_step()(u, v)
    assert tp.verify_stencil(out)
    assert not tp.verify_stencil(out * 1.01)


def test_padded_lattice_matches_reference_and_verifies():
    jp, tp = _plans(3, "aosoa", "float32", "", "none")  # 81 sites pad to 128
    assert tp.padded_sites == jp.padded_sites == 128
    ju, jv = jp.init_stencil_data()
    tu, tv = tp.init_stencil_data()
    np.testing.assert_array_equal(_bits(tu), _bits(ju))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    want, got = jp.stencil_step()(ju, jv), tp.stencil_step()(tu, tv)
    assert tp.verify_stencil(got) and jp.verify_stencil(want)
    np.testing.assert_allclose(tp.unpack_vec(got).numpy(), np.asarray(jp.unpack_vec(want)),
                               atol=1e-5)


@pytest.mark.parametrize("layout,comp", [("soa", "none"), ("aosoa", "two_row")])
def test_overlap_and_depth2_equal_serial_bitwise(layout, comp):
    _, tp = _plans(4, layout, "float32", "", comp)
    u, v = _field(4, 9)
    tu, tv = tp.pack_gauge(u), tp.pack_rhs(v)
    serial = tp.stencil_step(overlap=False)
    once = serial(tu, tv)
    assert tp.stencil_reference_step() is serial and tp.stencil_step() is serial
    np.testing.assert_array_equal(_bits(tp.stencil_step(overlap=True)(tu, tv)), _bits(once))
    twice = serial(tu, once)
    for overlap in (False, True):
        np.testing.assert_array_equal(
            _bits(tp.stencil_step(overlap=overlap, depth=2)(tu, tv)), _bits(twice))


def test_stencil_errors_match_reference(monkeypatch):
    jp, tp = _plans(2, "soa", "float32", "", "none", tile=16)
    for p in (jp, tp):
        with pytest.raises(ValueError, match="depth must be 1 or 2, got 3"):
            p.stencil_step(depth=3)

    def raw_step_error(reg, lay, plan_mod):
        entry = reg.get_kernel("pallas_stencil")
        with pytest.raises(ValueError) as exc:
            plan_mod.make_raw_step(lay.make_codec(lay.Layout.SOA, tile=16), entry, tile=16)
        return str(exc.value).replace(entry.name, "<name>")

    assert raw_step_error(tregistry, tl, tplan) == raw_step_error(jregistry, jl, jplan)

    def kwargs_errors(reg, lay, plan_mod, cfg_mod):
        msgs = []
        for layout, extra, flags in (
            ("aosoa", {}, {"layouts": (lay.Layout.SOA,)}),
            ("soa", {"dtype": "bfloat16", "accum_dtype": "float32"}, {}),
            ("soa", {"compression": "two_row"}, {}),
        ):
            stand_in = reg.KernelEntry(
                name="stand_in", fn=lambda *a, **k: None,
                layouts=flags.get("layouts", (lay.Layout.SOA, lay.Layout.AOSOA)),
                backends=("x",), form=reg.STENCIL)
            monkeypatch.setitem(reg._KERNELS, "stand_in", stand_in)
            cfg = cfg_mod.EngineConfig(L=2, tile=16, layout=lay.Layout(layout), **extra)
            p = plan_mod.build_plan(cfg, **({"device": "cpu"} if plan_mod is tplan else {}))
            with pytest.raises(ValueError) as exc:
                p._stencil_kernel_kwargs("stand_in")
            msgs.append(str(exc.value))
        return msgs

    assert kwargs_errors(tregistry, tl, tplan, tplan) == kwargs_errors(jregistry, jl, jplan,
                                                                       jplan)


def test_stencil_apply_reference_matches_reference():
    u, v = _field(3, 10)
    want = np.asarray(jplan.stencil_apply_reference(jnp.asarray(u), jnp.asarray(v), 3))
    got = tplan.stencil_apply_reference(torch.from_numpy(u), torch.from_numpy(v), 3)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    a, vv = tplan.init_stencil_canonical(16)
    assert torch.allclose(tplan.stencil_apply_reference(a, vv, 2), torch.ones_like(vv))


def test_stencil_halo_and_bounds():
    _, tp = _plans(4, "soa", "bfloat16", "float32", "none")
    halo = tp.stencil_halo(depth=2)
    assert (halo.n_shards, halo.word_bytes, halo.words_per_site, halo.depth) == (1, 2, 6, 2)
    assert halo.halo_bytes_per_exchange == 0  # one slab sends nothing
    from repro_torch.configs.su3_bench import PAPER_L32

    hw = roofline.H100_SXM
    assert roofline.stencil_bound(PAPER_L32, hw).bytes == 528_482_304
    two_row = dataclasses.replace(PAPER_L32, compression="two_row")
    assert roofline.stencil_bound(two_row, hw).bytes == 427_819_008
    bf16 = dataclasses.replace(PAPER_L32, dtype="bfloat16")
    assert roofline.stencil_bound(bf16, hw).bytes == 264_241_152
    terms = roofline.cg_iteration_bound(PAPER_L32, hw)
    assert terms["kernel"].bytes == 805_306_368 and terms["gathers"].bytes == 2 * 402_653_184
    assert terms["total"].bound_by == "bytes"
    assert terms["total"].bound_s == pytest.approx(1_912_602_624 / 3.35e12)
