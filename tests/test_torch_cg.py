"""The CG slice of the port against the JAX reference, on the CPU.

The fused CG body's plain version is held against the Pallas kernel in
interpret mode (tolerance ``verify_tolerance``; bitwise under pure bf16),
and ``ExecutionPlan.cg_solve`` against the reference plan's solve and the
port's plain ``cg_reference_solve`` on ``_cg_measure_problem`` (the same
numpy arrays in both packages): the iteration count equal and every
relative residual within 1e-3 relative.  Inside the port the fused and the
composed iterations are equal bit for bit at f32 (the reference's contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core.su3 import layouts as jl
from repro.core.su3 import plan as jplan
from repro.kernels import ops as jops
from repro_torch.core import autotune as tautotune
from repro_torch.core.su3 import layouts as tl
from repro_torch.core.su3 import plan as tplan
from repro_torch.core.su3.layouts import COMP_ROW_INDICES
from repro_torch.kernels import ops, su3_stencil

S = 256

FORMS = [  # (storage dtype, accum dtype, two-row)
    ("float32", None, False),
    ("bfloat16", "float32", False),
    ("bfloat16", None, False),
    ("float32", None, True),
    ("bfloat16", None, True),
    ("bfloat16", "float32", True),
]


def _links(seed: int, compressed: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((S, 4, 3, 3)) + 1j * rng.standard_normal((S, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)
    a = np.stack([q.real, q.imag]).transpose(0, 2, 3, 4, 1).reshape(2, 36, S)
    return a[:, list(COMP_ROW_INDICES)] if compressed else a


def _pair(x: np.ndarray, dtype: str):
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


@pytest.mark.parametrize("dtype,accum,compressed", FORMS)
def test_plain_cg_body_matches_pallas_kernel(dtype, accum, compressed):
    rng = np.random.default_rng(20)
    ju, tu = _pair(_links(19, compressed), dtype)
    (jrn, trn), (jpn, tpn) = (_pair(rng.standard_normal((8, 2, 3, S)), dtype) for _ in range(2))
    (jr, tr), (jp, tp) = (_pair(rng.standard_normal((2, 3, S)), dtype) for _ in range(2))
    coefs = np.array([[0.3718, 16.0]], np.float32)  # beta != 0
    kw = {"tile": S, "accum_dtype": accum, "compressed": compressed}
    want = jops.su3_cg_fused_planar(ju, jrn, jpn, jr, jp, jnp.asarray(coefs), **kw)
    got = ops.su3_cg_fused_planar(tu, trn, tpn, tr, tp, torch.from_numpy(coefs), **kw)
    for g, w in zip(got, want):
        assert g.dtype == tu.dtype and tuple(g.shape) == (2, 3, S)
        if dtype == "bfloat16" and accum is None:
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            err = np.max(np.abs(_np(g) - _np(w)))
            assert err <= jplan.verify_tolerance(dtype, accum or "", compressed), err


def test_cg_body_rejects_bad_coefs_and_counts_no_cpu_launch():
    _, tu = _pair(_links(1, False), "float32")
    z8, z = torch.zeros(8, 2, 3, S), torch.zeros(2, 3, S)
    before = su3_stencil.CG_LAUNCHES.count
    with pytest.raises(ValueError, match="coefs must be"):
        ops.su3_cg_fused_planar(tu, z8, z8, z, z, torch.zeros(2), tile=S)
    with pytest.raises(ValueError, match="coefs must be"):
        ops.su3_cg_fused_planar(tu, z8, z8, z, z, torch.zeros(1, 2, dtype=torch.float64), tile=S)
    with pytest.raises(ValueError, match="r must be"):
        ops.su3_cg_fused_planar(tu, z8, z8, z[:, :2], z, torch.zeros(1, 2), tile=S)
    p_new, s = ops.su3_cg_fused_planar(tu, z8, z8, z, z, torch.zeros(1, 2), tile=S)
    assert not p_new.any() and not s.any()
    assert su3_stencil.CG_LAUNCHES.count == before


def test_measure_problem_equals_reference():
    u, b = tautotune._cg_measure_problem(3)
    ju, jb = jautotune._cg_measure_problem(3)
    assert u.dtype == b.dtype == np.complex64 and u.shape == (81, 4, 3, 3) and b.shape == (81, 3)
    np.testing.assert_array_equal(u, np.asarray(ju))
    np.testing.assert_array_equal(b, np.asarray(jb))


def _plans(layout: str = "soa", dtype: str = "float32", accum: str = "", comp: str = "none",
           L: int = 4, tile: int = 64):
    fields = dict(L=L, dtype=dtype, accum_dtype=accum, compression=comp, tile=tile,
                  iterations=1, warmups=0)
    jp = jplan.build_plan(jplan.EngineConfig(layout=jl.Layout(layout), **fields))
    tp = tplan.build_plan(tplan.EngineConfig(layout=tl.Layout(layout), **fields), device="cpu")
    return jp, tp


def _rel_close(got: list[float], want: list[float], rel: float) -> None:
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * abs(w), (g, w)


@pytest.mark.parametrize("fused", [True, False])
def test_cg_solve_matches_reference_plan_and_oracle(fused):
    u, b = tautotune._cg_measure_problem(4)
    jp, tp = _plans()
    want = jp.cg_solve(jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(b)), fused=fused)
    got = tp.cg_solve(tp.pack_gauge(u), tp.pack_rhs(b), fused=fused)
    assert got.converged and got.iterations == want.iterations == 9
    _rel_close(got.residuals, want.residuals, 1e-3)
    _x, oracle, converged = tplan.cg_reference_solve(torch.from_numpy(u), torch.from_numpy(b), 4)
    assert converged
    _rel_close(got.residuals, oracle, 1e-3)
    assert got.residuals[-1] <= 1e-6 < got.residuals[-2]
    x = tp.unpack_vec(got.x_p)
    ax = tplan.CG_SHIFT * x + tplan.stencil_apply_reference(torch.from_numpy(u), x, 4)
    assert torch.linalg.norm(ax - torch.from_numpy(b)) <= 1e-5 * torch.linalg.norm(
        torch.from_numpy(b))


@pytest.mark.parametrize("layout", ["soa", "aosoa"])
@pytest.mark.parametrize("comp", ["none", "two_row"])
def test_fused_equals_composed_bitwise_at_f32(layout, comp):
    u, b = tautotune._cg_measure_problem(3, seed=11)  # 81 sites, padded to 128
    _, tp = _plans(layout, comp=comp, L=3)
    tu, tb = tp.pack_gauge(u), tp.pack_rhs(b)
    fused, composed = tp.cg_state_init(tb), tp.cg_state_init(tb)
    for _ in range(4):
        fused = tp.cg_iterate(tu, fused, fused=True)
        composed = tp.cg_iterate(tu, composed, fused=False)
        for key in ("x", "r", "p", "rs", "beta"):
            assert torch.equal(fused[key].view(torch.int32), composed[key].view(torch.int32)), key
    a = tp.cg_solve(tu, tb, fused=True)
    c = tp.cg_solve(tu, tb, fused=False)
    assert a.residuals == c.residuals and a.iterations == c.iterations
    assert torch.equal(a.x_p.view(torch.int32), c.x_p.view(torch.int32))


def test_bf16_storage_with_f32_accumulation_converges():
    u, b = tautotune._cg_measure_problem(3)
    _, tp = _plans("aosoa", "bfloat16", "float32", "two_row", L=3)
    res = tp.cg_solve(tp.pack_gauge(u), tp.pack_rhs(b), tol=2e-2)
    assert res.converged and res.residuals[-1] <= 2e-2 and res.x_p.dtype == torch.bfloat16


def test_zero_rhs_returns_at_once():
    u, b = tautotune._cg_measure_problem(2)
    _, tp = _plans(L=2, tile=16)
    before = su3_stencil.CG_LAUNCHES.count
    res = tp.cg_solve(tp.pack_gauge(u), tp.pack_rhs(np.zeros_like(b)))
    assert res.converged and res.iterations == 0 and res.residuals == []
    assert not res.x_p.any() and su3_stencil.CG_LAUNCHES.count == before


def test_max_iters_raises_with_partial_result_and_resume_converges():
    u, b = tautotune._cg_measure_problem(3)
    jp, tp = _plans(L=3)
    tu, tb = tp.pack_gauge(u), tp.pack_rhs(b)
    with pytest.raises(tplan.CGMaxItersError) as exc:
        tp.cg_solve(tu, tb, max_iters=3)
    err = exc.value
    assert err.iterations == 3 and err.result is not None and not err.result.converged
    assert len(err.result.residuals) == 3 and err.residual == pytest.approx(
        err.result.residuals[-1])
    with pytest.raises(jplan.CGMaxItersError) as jexc:
        jp.cg_solve(jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(b)), max_iters=3)
    assert str(err).split(":")[0] == str(jexc.value).split(":")[0]
    for fused in (True, False):
        resumed = tp.cg_solve(tu, tb, x0_p=err.result.x_p, fused=fused)
        assert resumed.converged and resumed.iterations < 9
        assert resumed.residuals[-1] <= 1e-6
    with pytest.raises(ValueError, match="needs u_phys") as exc2:
        tp.cg_state_init(tb, err.result.x_p)
    with pytest.raises(ValueError) as jexc2:
        jp.cg_state_init(jp.pack_rhs(jnp.asarray(b)), jnp.asarray(err.result.x_p.numpy()))
    assert str(exc2.value) == str(jexc2.value)


def test_diverged_errors_match_reference_messages():
    u, b = tautotune._cg_measure_problem(2)
    jp, tp = _plans(L=2, tile=16)
    bad_b = b.copy()
    bad_b[3, 1] = np.nan
    with pytest.raises(tplan.CGDivergedError) as exc:
        tp.cg_solve(tp.pack_gauge(u), tp.pack_rhs(bad_b))
    with pytest.raises(jplan.CGDivergedError) as jexc:
        jp.cg_solve(jp.pack_gauge(jnp.asarray(u)), jp.pack_rhs(jnp.asarray(bad_b)))
    assert str(exc.value) == str(jexc.value) and exc.value.reason == jexc.value.reason
    assert exc.value.result is None
    bad_u = u.copy()
    bad_u[5, 2, 1, 1] = np.inf  # a poisoned operator: the residual goes non-finite
    with pytest.raises(tplan.CGDivergedError) as exc:
        tp.cg_solve(tp.pack_gauge(bad_u), tp.pack_rhs(b))
    with pytest.raises(jplan.CGDivergedError) as jexc:
        jp.cg_solve(jp.pack_gauge(jnp.asarray(bad_u)), jp.pack_rhs(jnp.asarray(b)))
    assert str(exc.value) == str(jexc.value)
    assert exc.value.reason == "non-finite residual" and exc.value.iterations == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vectors_from_reference_round_trip(dtype):
    _, b = tautotune._cg_measure_problem(3)
    jp, tp = _plans(dtype=dtype, L=3)
    jb = jp.pack_rhs(jnp.asarray(b))
    jx = jp.codec.pack_vec(jnp.asarray(b[::-1].copy()), jp.padded_sites)
    tb, tx = tplan.vectors_from_reference(tp, np.asarray(jb), np.asarray(jx))
    assert tb.dtype == tp.codec.word_dtype and tb.device == tp.device
    np.testing.assert_array_equal(_bits(tb), _bits(jb))
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_array_equal(_bits(tp.pack_rhs(b)), _bits(jb))
    np.testing.assert_array_equal(tp.unpack_vec(tb).numpy(), np.asarray(jp.unpack_vec(jb)))
    with pytest.raises(ValueError, match="expected shape"):
        tplan.vectors_from_reference(tp, np.asarray(jb)[:, :, :81])
    other = np.zeros(np.asarray(jb).shape, np.float64)
    with pytest.raises(ValueError, match="expected"):
        tplan.vectors_from_reference(tp, other)
