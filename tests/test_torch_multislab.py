"""The multi-slab lattice path of the port, on the CPU.

``MeshSpec`` and the slab arithmetic against the JAX package's; per-slab
first-touch init and the multiply on several slabs against the one-slab
plan (bitwise); inside the port, the overlapped stencil at depth 1 and 2 on
1, 2 and 4 slabs against the serial step (bitwise, in every storage form);
the port's multi-slab stencil and overlapped CG against the JAX package's
serial ``stencil_step`` and ``cg_solve`` (within ``verify_tolerance``, with
the same iteration count); the overlapped fused CG against the composed
path (bitwise at f32); the ``halo`` fault seam; the tracer's phase spans.

L=8 gives 2 slabs interior t-slices (4 t-slices each, 2 on the boundary);
4 slabs of 2 t-slices are all boundary.  L=4 serves the degenerate slab
counts (a slab thinner than a face) and the CG iteration target (9
iterations to 1e-6, as in the reference's benchmark).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.su3 import layouts as jl
from repro.core.su3 import plan as jplan
from repro.distributed import sharding as jsharding
from repro.launch.mesh import MeshSpec as JMeshSpec
from repro_torch.chaos import NULL_FAULT_PLAN, FaultPlan, FaultSpec, corrupt_ghosts
from repro_torch.core import autotune as tautotune
from repro_torch.core.su3 import layouts as tl
from repro_torch.core.su3 import plan as tplan
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch.mesh import DEVICE_AXIS, HOST_AXIS, MeshSpec, SlabMesh
from repro_torch.obs import Tracer
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)


def _su3(n_sites: int, seed: int) -> np.ndarray:
    """Random SU(3) links (n_sites, 4, 3, 3) complex64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def _field(L: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed + 100)
    n = L**4
    v = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    return _su3(n, seed), v.astype(np.complex64)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()


def _cfg(L: int, layout: str = "soa", dtype: str = "float32", accum: str = "",
         comp: str = "none", tile: int = 64) -> tplan.EngineConfig:
    # AOS has no planar kernel: its plans run a plain torch variant
    return tplan.EngineConfig(L=L, layout=tl.Layout(layout), dtype=dtype, accum_dtype=accum,
                              compression=comp, tile=tile, iterations=1, warmups=0,
                              variant="versionX" if layout == "aos" else "cuda")


def _plan(cfg: tplan.EngineConfig, hosts: int) -> tplan.ExecutionPlan:
    return tplan.build_plan(cfg, MeshSpec(hosts=hosts).resolve("cpu"))


def _jmesh(hosts: int, dph: int = 1):
    """The reference's (hosts, devices) mesh over one repeated CPU device:
    construction only, never executed."""
    return JMeshSpec(hosts=hosts, devices_per_host=dph).resolve(
        [jax.devices()[0]] * (hosts * dph))


# -- MeshSpec and the slab arithmetic --------------------------------------------------


def test_meshspec_resolves_to_a_slab_mesh_on_one_device():
    mesh = MeshSpec(hosts=2, devices_per_host=2).resolve("cpu")
    assert isinstance(mesh, SlabMesh) and mesh.device == torch.device("cpu")
    assert mesh.axis_names == (HOST_AXIS, DEVICE_AXIS) == _jmesh(2, 2).axis_names
    assert mesh.shape == {"hosts": 2, "devices": 2} and mesh.n_devices == 4
    single = MeshSpec.single_host().resolve("cpu")
    assert single.axis_names == ("sites",) and single.n_devices == 1


def test_meshspec_validation_oversubscription_and_identity():
    with pytest.raises(ValueError, match="hosts"):
        MeshSpec(hosts=0)
    with pytest.raises(ValueError, match="devices_per_host"):
        MeshSpec(hosts=2, devices_per_host=-1)
    # one card: every simulated device of every host is the one device
    mesh = MeshSpec(hosts=2, devices_per_host=3).resolve("cpu")
    assert (mesh.n_devices, mesh.device) == (6, torch.device("cpu"))
    for args in ((1, 0), (2, 0), (4, 1), (2, 2)):
        t, j = MeshSpec(*args), JMeshSpec(*args)
        assert t.describe() == j.describe() and t.is_multi_host == j.is_multi_host
    assert MeshSpec(2, 2).n_devices() == 4 and MeshSpec(2).n_devices() == 2
    assert MeshSpec.simulated(4) == MeshSpec(hosts=4)


def test_meshspec_resolves_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshSpec(hosts=2).resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplan.build_plan(_cfg(4), MeshSpec(hosts=2))


@pytest.mark.parametrize("hosts,dph", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_lattice_axes_and_host_ranges_match_reference(hosts, dph):
    mesh, jmesh = MeshSpec(hosts, dph).resolve("cpu"), _jmesh(hosts, dph)
    assert tsharding.lattice_site_axes(mesh) == jsharding.lattice_site_axes(jmesh)
    assert tsharding.lattice_is_multi_host(mesh) == jsharding.lattice_is_multi_host(jmesh)
    assert tsharding.host_site_ranges(256, mesh) == jsharding.host_site_ranges(256, jmesh)
    if hosts > 1:
        with pytest.raises(ValueError, match="divide"):
            tsharding.host_site_ranges(255, mesh)


# -- first touch and the multiply on several slabs -------------------------------------


@pytest.mark.parametrize("layout", ["aos", "soa", "aosoa"])
def test_uniform_shard_matches_codec_pack_and_reference(layout):
    codec = tl.make_codec(tl.Layout(layout), tile=16)
    want = codec.pack(tplan.init_canonical(32)[0]).numpy()
    np.testing.assert_array_equal(tplan._uniform_phys_shard(codec, 32, 0), want)
    jcodec = jl.make_codec(jl.Layout(layout), tile=16)
    np.testing.assert_array_equal(tplan._uniform_phys_shard(codec, 16, 100),
                                  jplan._uniform_phys_shard(jcodec, 16, 100))


@pytest.mark.parametrize("layout,dtype,accum,comp", [
    ("aos", "float32", "", "none"), ("soa", "float32", "", "none"),
    ("aosoa", "float32", "", "none"), ("soa", "bfloat16", "float32", "none"),
    ("aosoa", "float32", "", "two_row"), ("aos", "bfloat16", "", "none"),
])
@pytest.mark.parametrize("hosts", [2, 4])
def test_first_touch_and_step_equal_one_slab_bitwise(layout, dtype, accum, comp, hosts):
    cfg = _cfg(8, layout, dtype, accum, comp, tile=16)
    one, many = _plan(cfg, 1), _plan(cfg, hosts)
    assert many.n_hosts == hosts and many.is_multi_host and many.site_axes == ("hosts", "devices")
    a1, b1, _, _ = one.init_data()
    a2, b2, _, _ = many.init_data()  # per-slab first touch
    np.testing.assert_array_equal(_bits(a2), _bits(a1))
    np.testing.assert_array_equal(_bits(many.step(a2, b2)), _bits(one.step(a1, b1)))
    assert many.verify(many.step(a2, b2))
    assert many.describe() == one.describe().replace("@1dev:", f"@{hosts}devx{hosts}h:")


def test_plan_slab_geometry_and_padding():
    p = tplan.build_plan(_cfg(4, tile=64), MeshSpec(hosts=2, devices_per_host=2).resolve("cpu"))
    assert (p.n_hosts, p.n_devices, p.padded_sites) == (2, 4, 256)
    assert p.halo().as_dict() == jsharding.HaloSpec(L=4, n_shards=2).as_dict()
    assert p.stencil_halo().words_per_site == 6 and p.stencil_halo().n_shards == 2
    one = tplan.build_plan(_cfg(4), "cpu")
    assert (one.n_hosts, one.is_multi_host, one.halo().boundary_sites) == (1, False, 0)
    # a bare device is one slab; a SlabMesh is taken as it is
    mesh = MeshSpec(hosts=4).resolve("cpu")
    assert tplan.build_plan(_cfg(4), mesh).mesh is mesh


# -- the stencil schedules: bitwise inside the port ------------------------------------


FORMS = [  # (layout, dtype, accum, compression)
    ("soa", "float32", "", "none"),
    ("aosoa", "float32", "", "none"),
    ("soa", "bfloat16", "float32", "none"),
    ("soa", "float32", "", "two_row"),
    ("aosoa", "bfloat16", "", "two_row"),
]


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("layout,dtype,accum,comp", FORMS)
def test_overlap_and_depth2_equal_serial_bitwise(layout, dtype, accum, comp, hosts):
    p = _plan(_cfg(8, layout, dtype, accum, comp), hosts)
    u, v = _field(8, 3)
    tu, tv = p.pack_gauge(u), p.pack_rhs(v)
    serial = p.stencil_step(overlap=False)
    once = serial(tu, tv)
    twice = serial(tu, once)
    assert p.stencil_step() is p.stencil_step(overlap=hosts > 1)
    for overlap in (False, True):
        np.testing.assert_array_equal(_bits(p.stencil_step(overlap=overlap)(tu, tv)),
                                      _bits(once))
        np.testing.assert_array_equal(_bits(p.stencil_step(overlap=overlap, depth=2)(tu, tv)),
                                      _bits(twice))
    if hosts > 1:  # every slab count gives the one-slab plan's bits
        np.testing.assert_array_equal(_bits(once), _bits(_plan(p.cfg, 1).stencil_step()(tu, tv)))


@pytest.mark.parametrize("hosts,tile", [(8, 16), (16, 16)])
def test_degenerate_slabs_thinner_than_a_face(hosts, tile):
    p = _plan(_cfg(4, tile=tile), hosts)
    assert p.stencil_halo().boundary_sites == p.stencil_halo().sites_per_shard  # all boundary
    u, v = _field(4, 5)
    tu, tv = p.pack_gauge(u), p.pack_rhs(v)
    serial = p.stencil_step(overlap=False)
    once = serial(tu, tv)
    np.testing.assert_array_equal(_bits(p.stencil_step()(tu, tv)), _bits(once))
    np.testing.assert_array_equal(_bits(p.stencil_step(depth=2)(tu, tv)),
                                  _bits(serial(tu, once)))


def test_fixed_point_holds_on_first_touched_slabs():
    p = _plan(_cfg(8, "aosoa"), 4)
    u, v = p.init_stencil_data()
    assert p.verify_stencil(p.stencil_step()(u, v))


# -- against the JAX package -------------------------------------------------------------


JAX_FORMS = [("soa", "float32", "", "none"), ("aosoa", "bfloat16", "float32", "none"),
             ("soa", "float32", "", "two_row")]


@pytest.fixture(scope="module")
def jax_stencil():
    """The JAX package's serial stencil, once and twice, per form at L=8."""
    out = {}
    u, v = _field(8, 11)
    for form in JAX_FORMS:
        layout, dtype, accum, comp = form
        jp = jplan.build_plan(jplan.EngineConfig(
            L=8, layout=jl.Layout(layout), dtype=dtype, accum_dtype=accum, compression=comp,
            tile=512, iterations=1, warmups=0))
        ju, jv = jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(v))
        step = jp.stencil_step()
        once = step(ju, jv)
        out[form] = (np.asarray(jp.unpack_vec(once)),
                     np.asarray(jp.unpack_vec(step(ju, once))))
    return u, v, out


@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("form", JAX_FORMS)
def test_multislab_stencil_matches_reference(jax_stencil, form, hosts):
    u, v, ref = jax_stencil
    layout, dtype, accum, comp = form
    p = _plan(_cfg(8, layout, dtype, accum, comp), hosts)
    tu, tv = p.pack_gauge(u), p.pack_rhs(v)
    tol = tplan.verify_tolerance(dtype, accum, comp == "two_row")
    for depth, want in ((1, ref[form][0]), (2, ref[form][1])):
        got = p.unpack_vec(p.stencil_step(overlap=True, depth=depth)(tu, tv)).numpy()
        assert np.max(np.abs(got - want)) <= tol * max(1.0, float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def jax_cg():
    """The JAX package's serial fused ``cg_solve`` on the measurement
    problem, at L=4 and L=8."""
    out = {}
    for L in (4, 8):
        u, b = tautotune._cg_measure_problem(L)
        jp = jplan.build_plan(jplan.EngineConfig(L=L, tile=256, iterations=1, warmups=0))
        res = jp.cg_solve(jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(b)))
        out[L] = (res.iterations, list(res.residuals), np.asarray(jp.unpack_vec(res.x_p)))
    return out


@pytest.mark.parametrize("L,hosts", [(4, 2), (4, 4), (8, 2), (8, 4)])
def test_overlapped_cg_matches_reference(jax_cg, L, hosts):
    iters, residuals, x_ref = jax_cg[L]
    u, b = tautotune._cg_measure_problem(L)
    p = _plan(_cfg(L), hosts)
    res = p.cg_solve(p.pack_gauge(u), p.pack_rhs(b), fused=True, overlap=True)
    assert res.converged and res.iterations == iters == 9
    for g, w in zip(res.residuals, residuals, strict=True):
        assert abs(g - w) <= 1e-3 * w, (g, w)
    assert np.max(np.abs(p.unpack_vec(res.x_p).numpy() - x_ref)) <= tplan.verify_tolerance(
        "float32")


@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("layout,comp", [("soa", "none"), ("aosoa", "none"),
                                         ("soa", "two_row")])
def test_overlapped_fused_cg_equals_composed_and_one_slab_bitwise(layout, comp, hosts):
    u, b = tautotune._cg_measure_problem(8, seed=13)
    p, one = _plan(_cfg(8, layout, comp=comp), hosts), _plan(_cfg(8, layout, comp=comp), 1)
    tu, tb = p.pack_gauge(u), p.pack_rhs(b)
    fused, composed, single = (p.cg_state_init(tb), p.cg_state_init(tb), one.cg_state_init(tb))
    for _ in range(4):
        fused = p.cg_iterate(tu, fused, fused=True)  # overlap: the default on slabs
        composed = p.cg_iterate(tu, composed, fused=False, overlap=True)
        single = one.cg_iterate(tu, single, fused=True)
        for key in ("x", "r", "p", "rs", "beta"):
            assert torch.equal(_bits_t(fused[key]), _bits_t(composed[key])), key
            assert torch.equal(_bits_t(fused[key]), _bits_t(single[key])), key
    a = p.cg_solve(tu, tb, fused=True, overlap=True)
    c = p.cg_solve(tu, tb, fused=False, overlap=True)
    assert a.residuals == c.residuals and a.iterations == c.iterations
    assert torch.equal(_bits_t(a.x_p), _bits_t(c.x_p))


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def test_bf16_overlapped_cg_converges_like_one_slab():
    u, b = tautotune._cg_measure_problem(8)
    cfg = _cfg(8, dtype="bfloat16", accum="float32")
    one, many = _plan(cfg, 1), _plan(cfg, 2)
    r1 = one.cg_solve(one.pack_gauge(u), one.pack_rhs(b), tol=2e-2)
    r2 = many.cg_solve(many.pack_gauge(u), many.pack_rhs(b), tol=2e-2)
    assert r2.converged and r2.iterations == r1.iterations and r2.residuals == r1.residuals


# -- the halo fault seam -------------------------------------------------------------------


def test_corrupt_ghosts_drop_and_corrupt():
    ghosts = (torch.ones(2, 3, 8), torch.full((8, 2, 3, 4), 2.0, dtype=torch.bfloat16))
    dropped = corrupt_ghosts(ghosts, "drop")
    assert all(bool((g == 0).all()) for g in dropped)
    assert [(g.shape, g.dtype) for g in dropped] == [(g.shape, g.dtype) for g in ghosts]
    mangled = corrupt_ghosts(ghosts, "corrupt")
    assert all(bool(torch.isnan(g).all()) for g in mangled)
    assert bool((ghosts[0] == 1).all())  # the exchanged tensors are left as they were


@pytest.mark.parametrize("depth", [1, 2])
def test_halo_fault_corrupts_only_faulted_steps(depth):
    p = _plan(_cfg(8), 2)
    u, v = p.init_stencil_data()
    step = p.stencil_step(overlap=True, depth=depth)
    clean = step(u, v).clone()
    p.faults = FaultPlan(7, {"halo": FaultSpec(probability=1.0, actions=("drop",))})
    dropped = step(u, v).clone()
    assert p.faults.fired == 1 and p.faults.log()[0]["ctx"] == {"depth": depth}
    assert not torch.equal(dropped, clean)
    p.faults = FaultPlan(7, {"halo": FaultSpec(probability=1.0, actions=("corrupt",))})
    assert not bool(torch.isfinite(step(u, v)).all())
    p.faults = NULL_FAULT_PLAN
    assert torch.equal(step(u, v), clean)


# -- the tracer's phase spans ----------------------------------------------------------------


def test_traced_schedules_emit_phase_spans_and_keep_the_bits():
    p = _plan(_cfg(8), 2)
    u, v = _field(8, 21)
    tu, tv = p.pack_gauge(u), p.pack_rhs(v)
    untraced = {d: p.stencil_step(depth=d)(tu, tv).clone() for d in (1, 2)}
    p.tracer = Tracer()
    for d in (1, 2):
        assert torch.equal(p.stencil_step(depth=d)(tu, tv), untraced[d])
    spans = p.tracer.spans()
    steps = [s for s in spans if s.name == "stencil.step"]
    assert [s.attrs["depth"] for s in steps] == [1, 2]
    assert steps[0].attrs == {"L": 8, "tile": 64, "dtype": "float32", "compression": "none",
                              "hosts": 2, "overlap": True, "depth": 1,
                              "flops": 576.0 * 8**4}
    children = {s.span_id: [c.name for c in spans if c.parent_id == s.span_id] for s in steps}
    assert children[steps[0].span_id] == ["stencil.exchange", "stencil.interior",
                                          "stencil.boundary"]
    assert children[steps[1].span_id] == [
        "stencil.exchange", "stencil.interior", "stencil.boundary", "stencil.ring",
        "stencil.interior", "stencil.boundary"]
    p.tracer = Tracer()
    ub, b = tautotune._cg_measure_problem(8)
    res = p.cg_solve(p.pack_gauge(ub), p.pack_rhs(b))
    names = [s.name for s in p.tracer.spans()]
    assert names.count("cg.iter") == res.iterations + 1  # one iteration past convergence
    assert names.count("cg.reduce") == res.iterations
    for phase in ("cg.exchange", "cg.interior", "cg.boundary"):
        assert names.count(phase) == res.iterations + 1, phase
