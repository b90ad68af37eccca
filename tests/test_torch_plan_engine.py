"""ExecutionPlan and SU3Engine of the PyTorch port against the JAX reference.

Plans are built on the CPU (``device="cpu"``), where the planar kernel runs
its plain version.  A lattice is carried from the reference plan into the
port with ``state_from_reference``; one step and a fused 3-chain must then
agree within ``verify_tolerance``.  The last test guards the separation:
the port imports neither jax nor the reference package.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.su3 import layouts as jl
from repro.core.su3 import plan as jplan
from repro.core.su3 import registry as jregistry
from repro.core.su3.engine import SU3Engine as JEngine
from repro_torch.core.su3 import layouts as tl
from repro_torch.core.su3 import plan as tplan
from repro_torch.core.su3 import registry as tregistry
from repro_torch.core.su3.engine import SU3Engine

REPO = pathlib.Path(__file__).resolve().parents[1]

DTYPES = [("float32", ""), ("bfloat16", "float32"), ("bfloat16", "")]


def _configs(L: int, layout: str, dtype: str, accum: str, comp: str, **kw):
    """The same EngineConfig fields on both sides (the reference's variant
    name "pallas" maps onto the port's "cuda")."""
    fields = dict(L=L, layout=layout, dtype=dtype, accum_dtype=accum, compression=comp,
                  variant="pallas", tile=16, iterations=1, warmups=0, **kw)
    jcfg = jplan.EngineConfig(**{**fields, "layout": jl.Layout(layout)})
    tcfg = tplan.EngineConfig(**{**fields, "layout": tl.Layout(layout)})
    return jcfg, tcfg


def _np(x) -> np.ndarray:
    """jax array -> numpy, or torch tensor -> numpy; bf16 as f32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jax.device_get(x)
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _su3(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


@pytest.mark.parametrize("L", [3, 4])  # L=3: 81 sites pad to 96
@pytest.mark.parametrize("layout", ["soa", "aosoa"])
@pytest.mark.parametrize("dtype,accum", DTYPES)
@pytest.mark.parametrize("comp", ["none", "two_row"])
def test_build_plan_and_init_data_match_reference(L, layout, dtype, accum, comp):
    jcfg, tcfg = _configs(L, layout, dtype, accum, comp)
    jp, tp = jplan.build_plan(jcfg), tplan.build_plan(tcfg, device="cpu")
    assert tp.padded_sites == jp.padded_sites
    assert tp.device == torch.device("cpu") and tp.kernel.name == "cuda"
    ja, jb, _, _ = jp.init_data()
    ta, tb, init_s, scatter_s = tp.init_data()
    assert tuple(ta.shape) == tuple(ja.shape) == tp.codec.phys_shape(tp.padded_sites)
    assert ta.dtype == tp.codec.word_dtype and init_s >= 0 and scatter_s == 0.0
    np.testing.assert_array_equal(_np(ta), _np(ja))
    np.testing.assert_array_equal(_np(tb), _np(jb))
    assert tp.verify(tp.step(ta, tb))  # su3_bench's fixed point
    assert tp.describe() == jp.describe().replace("@1dev/", "@1dev:cpu/")


STEP_CASES = [  # (layout, dtype, accum, comp)
    ("soa", "float32", "", "none"),
    ("aosoa", "float32", "", "two_row"),
    ("soa", "bfloat16", "float32", "two_row"),
    ("aosoa", "bfloat16", "float32", "none"),
]


@pytest.mark.parametrize("layout,dtype,accum,comp", STEP_CASES)
def test_step_and_fused_step_on_carried_lattice(layout, dtype, accum, comp):
    jcfg, tcfg = _configs(4, layout, dtype, accum, comp)
    jp, tp = jplan.build_plan(jcfg), tplan.build_plan(tcfg, device="cpu")
    u = _su3(jp.padded_sites, 11)
    ja = jp.codec.pack(jnp.asarray(u))
    jb = jp.codec.pack_b(jnp.asarray(_su3(1, 12)[0]))
    ta, tb = tplan.state_from_reference(tp, np.asarray(ja), np.asarray(jb))
    np.testing.assert_array_equal(_np(ta), _np(ja))
    tol = tplan.verify_tolerance(dtype, accum, comp == "two_row")
    for jstep, tstep in ((jp.step, tp.step), (jp.fused_step(3), tp.fused_step(3))):
        want, got = _np(jstep(ja, jb)), _np(tstep(ta, tb))
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= tol
    np.testing.assert_array_equal(_np(ta), _np(ja))  # step left A intact


def test_state_from_reference_checks_shapes_and_dtypes():
    jcfg, tcfg = _configs(3, "aosoa", "bfloat16", "float32", "none")
    tp = tplan.build_plan(tcfg, device="cpu")
    ja, jb, _, _ = jplan.build_plan(jcfg).init_data()
    a, b = tplan.state_from_reference(tp, np.asarray(ja), np.asarray(jb))
    assert a.dtype == torch.bfloat16 and a.device == tp.device
    with pytest.raises(ValueError, match="expected shape"):
        tplan.state_from_reference(tp, np.asarray(ja)[:1], np.asarray(jb))
    with pytest.raises(ValueError, match="expected bfloat16"):
        tplan.state_from_reference(tp, np.asarray(ja).astype(np.float32), np.asarray(jb))


@pytest.mark.parametrize("placement", tplan.PLACEMENTS)
def test_placements_give_identical_verified_output(placement):
    _, tcfg = _configs(4, "soa", "float32", "", "none", placement=placement)
    tp = tplan.build_plan(tcfg, device="cpu")
    a, b, _, scatter_s = tp.init_data()
    c = tp.step(a, b)
    assert tp.verify(c) and scatter_s >= 0.0
    _, base_cfg = _configs(4, "soa", "float32", "", "none")
    base = tplan.build_plan(base_cfg, device="cpu")
    assert torch.equal(c, base.step(*base.init_data()[:2]))
    if placement == "replicated":
        assert "replicated(=sharded on 1 device)" in tp.describe()


def _fake_entry(mod, form: str, **kw):
    return mod.KernelEntry(name="stand_in", fn=lambda *a, **k: None,
                           layouts=(mod.Layout.SOA,), backends=("x",), form=form, **kw)


@pytest.mark.parametrize("case", ["layout", "batched", "stencil", "stencil_axpy", "fused",
                                  "accum", "compressed"])
def test_make_raw_step_errors_match_reference(case):
    def errors(reg, lay, plan_mod):
        codec_kw = {}
        kernel = _fake_entry(reg, reg.PLANAR, supports_fused=True)
        k_iters = 1
        layout = lay.Layout.SOA
        if case == "layout":
            layout = lay.Layout.AOS
        elif case in ("batched", "stencil", "stencil_axpy"):
            kernel = _fake_entry(reg, case)
        elif case == "fused":
            kernel, k_iters = _fake_entry(reg, reg.PLANAR), 2
        elif case == "accum":
            codec_kw = {"dtype": "bfloat16", "accum_dtype": "float32"}
        else:
            codec_kw = {"compression": "two_row"}
        codec = lay.make_codec(layout, tile=16, **codec_kw)
        with pytest.raises(ValueError) as exc:
            plan_mod.make_raw_step(codec, kernel, tile=16, k_iters=k_iters)
        return str(exc.value)

    assert errors(tregistry, tl, tplan) == errors(jregistry, jl, jplan)


def test_plan_rejects_invalid_combinations_like_reference():
    with pytest.raises(ValueError, match="layout"):
        tplan.build_plan(tplan.EngineConfig(L=2, layout=tl.Layout.AOS, tile=16), device="cpu")
    with pytest.raises(KeyError, match="unknown SU3 kernel"):
        tplan.build_plan(tplan.EngineConfig(L=2, variant="nope", tile=16), device="cpu")
    with pytest.raises(ValueError, match="placement"):
        tplan.build_plan(tplan.EngineConfig(L=2, tile=16, placement="socket0"), device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        tplan.build_plan(tplan.EngineConfig(L=2, tile=16), device="cpu").fused_step(0)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplan.build_plan(tplan.EngineConfig(L=2, tile=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SU3Engine(tplan.EngineConfig(L=2, tile=16))


def test_engine_rows_keep_reference_keys():
    jcfg, tcfg = _configs(2, "soa", "float32", "", "none", placement="host_scatter")
    jrow = JEngine(jcfg).run().row()
    engine = SU3Engine(tcfg, device="cpu")
    row = engine.run().row()
    assert set(jrow) <= set(row)
    assert set(row) - set(jrow) == {"device", "bound_s", "bound_share"}
    assert row["verified"] and row["device"] == "cpu" and row["bound_s"] is None
    for key in ("L", "layout", "placement", "dtype", "compression", "devices",
                "bytes_per_site", "fused_k"):
        assert row[key] == jrow[key], key
    fused = engine.run_fused(3)
    assert fused.verified and fused.fused_k == 3 and len(fused.iter_seconds) == 3
    cmp = engine.compare_fused(2, reps=2)
    assert cmp["result"].verified and cmp["k"] == 2


def test_bench_result_bound_on_a_known_card():
    _, tcfg = _configs(32, "soa", "float32", "", "none")
    from repro_torch.core.su3.engine import BenchResult

    r = BenchResult(config=tcfg, n_devices=1, init_seconds=0.0, scatter_seconds=0.0,
                    iter_seconds=[0.36e-3], verified=True, device="NVIDIA H100 80GB HBM3")
    # 1,048,576 sites x 576 B over 3.35 TB/s
    assert r.bound_seconds == pytest.approx(603979776 / 3.35e12)
    assert r.bound_share == pytest.approx(603979776 / 3.35e12 / 0.36e-3)
    r8 = dataclasses.replace(r, fused_k=8)
    assert r8.bound_seconds == pytest.approx(603979776 / 3.35e12 / 8)
    assert dataclasses.replace(r, device="NVIDIA A100-SXM4-80GB").bound_seconds is None


_IMPORTS = re.compile(r"^\s*(import jax\b|from jax\b|import repro(\.|\s|$)|from repro(\.|\s))",
                      re.MULTILINE)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if _IMPORTS.search(f.read_text())]
    assert offenders == []
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": f"{REPO / 'src'}{os.pathsep}{REPO}"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_roofline_spec_by_device_name_and_chain_bound():
    from repro_torch.core import roofline

    assert roofline.hardware_for_device("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    assert roofline.hardware_for_device("NVIDIA H100 PCIe") is roofline.H100_PCIE
    for unknown in ("NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert roofline.hardware_for_device(unknown) is None
    n, bps = 32**4, 576
    one = roofline.analytic_su3_report(n_sites=n, bytes_per_site_rw=bps, hw=roofline.H100_SXM)
    assert one.bound_by == "bytes" and one.bound_s == pytest.approx(n * bps / 3.35e12)
    # the chain moves the same bytes for k x the flops: bytes-bound up to k ~ 13
    assert roofline.analytic_su3_report(n_sites=n, bytes_per_site_rw=bps, k=13,
                                        hw=roofline.H100_SXM).bound_by == "bytes"
    deep = roofline.analytic_su3_report(n_sites=n, bytes_per_site_rw=bps, k=14,
                                        hw=roofline.H100_SXM)
    assert deep.bound_by == "operations" and deep.bound_s == pytest.approx(14 * 864 * n / 67e12)
