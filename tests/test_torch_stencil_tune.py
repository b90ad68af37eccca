"""The stencil and CG tuners, attribution and provenance of the port, on the
CPU.

``predict_stencil`` and ``predict_cg`` charge the exchange of a multi-slab
plan on one card (its bytes at the H100 SXM's HBM rate) and nothing on one
slab; the pruned sweeps land within 5 % of the exhaustive ones (the
reference's gate, ``tests/test_stencil.py``); real measurements on a tiny
grid verify; the decisions persist and are served from the cache.  The
attribution report joins synthetic and real traced spans against the
predictors; the provenance block is complete and its gate names what is
missing or changed.  Geometry shared with the reference (the halo bytes of
a slab) is checked against the JAX package.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.obs import attribution as jattribution
from repro_torch.core import autotune, roofline
from repro_torch.core.su3 import plan as tplan
from repro_torch.kernels import su3_stencil
from repro_torch.launch.mesh import MeshSpec
from repro_torch.obs import (
    REQUIRED_PROVENANCE_KEYS,
    Tracer,
    attribution_report,
    overlap_efficiency,
    overlap_efficiency_from_spans,
    provenance_block,
    provenance_problems,
    render_attribution,
)
from repro_torch.obs.tracer import load_jsonl

HW = roofline.H100_SXM


# -- the stencil model ------------------------------------------------------------------


def test_stencil_ops_per_site_counts_the_kernel():
    assert autotune.stencil_ops_per_site() == 570
    assert autotune.stencil_ops_per_site(cg=True) == 570 + 108
    assert autotune.stencil_ops_per_site("bfloat16") == 3 * 570
    assert autotune.stencil_ops_per_site("bfloat16", "float32") == 570
    assert autotune.stencil_ops_per_site(compression="two_row") == 570 + 168
    assert autotune.stencil_ops_per_site("bfloat16", cg=True) == 3 * 678 + 2
    assert autotune.stencil_ops_per_site("bfloat16", compression="two_row") == 3 * 570 + 168 + 48


def test_predict_stencil_charges_the_exchange_only_on_split_schedules():
    serial1 = autotune.predict_stencil(autotune.StencilCandidate(64, False), L=4, hosts=1, hw=HW)
    assert serial1["halo_s"] == 0.0 and serial1["exchange_bytes"] == 0
    assert serial1["bound_s"] == serial1["core_s"]
    ovl1 = autotune.predict_stencil(autotune.StencilCandidate(64, True), L=4, hosts=1, hw=HW)
    assert ovl1["bound_s"] == serial1["bound_s"]  # one slab: the same program

    cfg = tplan.EngineConfig(L=8, tile=64)
    stream = roofline.stencil_bound(cfg, HW).bytes
    serial = autotune.predict_stencil(autotune.StencilCandidate(64, False), L=8, hosts=2, hw=HW)
    assert serial["bound_s"] == serial["core_s"] and serial["bandwidth_bytes"] == stream
    ovl = autotune.predict_stencil(autotune.StencilCandidate(64, True), L=8, hosts=2, hw=HW)
    # the ghosts of every boundary site of both slabs, read and written once
    assert ovl["exchange_bytes"] == 2 * (2 * 2 * 1024) * 6 * 4
    assert ovl["bandwidth_bytes"] == stream + ovl["exchange_bytes"]
    assert ovl["halo_s"] == pytest.approx(
        autotune.HALO_EXCHANGE_LATENCY_S + ovl["exchange_bytes"] / HW.hbm_bw)
    assert ovl["boundary_fraction"] == 0.5
    assert ovl["bound_s"] == pytest.approx(
        max(ovl["core_s"], ovl["halo_s"]) + 0.5 * ovl["core_s"])
    d2 = autotune.predict_stencil(autotune.StencilCandidate(64, True, 2), L=8, hosts=2, hw=HW)
    assert d2["exchange_bytes"] == 9 * ovl["exchange_bytes"]  # ghosts + the ring's 8 directions
    assert d2["bound_s"] == pytest.approx(max(d2["core_s"], d2["halo_s"]) + 2 * 0.5 * d2["core_s"])
    assert d2["issue_s"] > ovl["issue_s"] > serial["issue_s"]  # 2.5, 2, 1 launches
    # the split schedule never predicts faster than the serial one on one card
    assert ovl["predicted_gflops"] < serial["predicted_gflops"]


def test_predict_stencil_halo_geometry_matches_reference(monkeypatch):
    monkeypatch.setattr(jautotune, "stencil_instruction_model",
                        lambda dtype="float32", accum_dtype="", compression="none": 500.0)
    for L, hosts, dtype in ((4, 2, "float32"), (8, 4, "bfloat16"), (8, 2, "float32")):
        for depth in (1, 2):
            want = jautotune.predict_stencil(jautotune.StencilCandidate(64, True, depth), L=L,
                                             hosts=hosts, dtype=dtype)
            got = autotune.predict_stencil(autotune.StencilCandidate(64, True, depth), L=L,
                                           hosts=hosts, dtype=dtype, hw=HW)
            for key in ("halo_bytes_per_exchange", "boundary_fraction", "tile", "depth",
                        "overlap", "hosts"):
                assert got[key] == want[key], key


def test_predict_stencil_needs_a_card_spec(monkeypatch):
    monkeypatch.setattr(roofline, "current_hardware", lambda: None)
    with pytest.raises(LookupError, match="no Hopper spec"):
        autotune.predict_stencil(autotune.StencilCandidate(64, False), L=4)


def test_stencil_enumeration_and_register_gate(monkeypatch):
    cands = autotune.enumerate_stencil_candidates(tiles=(128, 256), device="cpu")
    assert len(cands) == 6 and {(c.overlap, c.depth) for c in cands} == {
        (False, 1), (True, 1), (True, 2)}
    budgets = {"stencil": {"local_bytes": 0, "blocks_per_sm": 4},
               "cg": {"local_bytes": 64, "blocks_per_sm": 4}}
    monkeypatch.setattr(su3_stencil, "kernel_budget",
                        lambda kernel, *a, **k: budgets[kernel])
    assert len(autotune.enumerate_stencil_candidates(tiles=(128,), device="cuda")) == 3
    # the CG body spills: only the composed form is a candidate
    cg = autotune.enumerate_cg_candidates(tiles=(128, 256), device="cuda")
    assert {c.fused for c in cg} == {False} and len(cg) == 2
    budgets["stencil"] = {"local_bytes": 0, "blocks_per_sm": 0}
    assert autotune.enumerate_stencil_candidates(tiles=(128,), device="cuda") == []
    with pytest.raises(RuntimeError, match="register budget"):
        autotune.stencil_sweep(L=4, hosts=2, device="cuda", hw=HW)


def _wiggle(pred: float, cand) -> float:
    key = 7.0 * cand.tile + (13.0 if getattr(cand, "overlap", getattr(cand, "fused", 0)) else 3.0)
    return pred * (1.0 + 0.03 * math.sin(key + getattr(cand, "depth", 1)))


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_stencil_pruned_sweep_within_5pct_of_exhaustive(hosts):
    measured = []

    def measure(cand):
        measured.append(cand)
        pred = autotune.predict_stencil(cand, L=8, hosts=hosts, hw=HW)["predicted_gflops"]
        return {"tile": cand.tile, "overlap": cand.overlap, "depth": cand.depth,
                "measured_gflops": _wiggle(pred, cand), "verified": True}

    full = autotune.stencil_sweep(L=8, hosts=hosts, prune=1.0, measure_fn=measure, hw=HW,
                                  device="cpu")
    assert full["candidates_measured"] == full["candidates_total"] == 18
    best_full = max(r["measured_gflops"] for r in full["rows"])
    measured.clear()
    pruned = autotune.stencil_sweep(L=8, hosts=hosts, prune=0.5, measure_fn=measure, hw=HW,
                                    device="cpu")
    assert len(measured) == pruned["candidates_measured"] <= math.ceil(0.5 * 18)
    assert max(r["measured_gflops"] for r in pruned["rows"]) >= 0.95 * best_full
    for row in pruned["rows"]:
        assert {"halo_bytes_per_exchange", "exchange_bytes", "bandwidth_bytes",
                "predicted_rank", "halo_s"} <= set(row)


def test_stencil_sweep_real_measurements_on_two_slabs():
    sweep = autotune.stencil_sweep(L=4, hosts=2, prune=0.5, tiles=(16, 32), hw=HW, device="cpu")
    assert sweep["candidates_total"] == 6 and sweep["candidates_measured"] == 3
    for row in sweep["rows"]:
        assert row["verified"], row
        assert row["measured_gflops"] > 0.0


def test_measure_stencil_candidate_verifies_every_schedule():
    for overlap, depth in ((False, 1), (True, 1), (True, 2)):
        row = autotune.measure_stencil_candidate(autotune.StencilCandidate(16, overlap, depth),
                                                 L=4, hosts=4, device="cpu")
        assert row["verified"] and (row["overlap"], row["depth"]) == (overlap, depth)


def test_best_stencil_config_persists_and_caches(tmp_path):
    def stub(cand):
        return {"tile": cand.tile, "overlap": cand.overlap, "depth": cand.depth,
                "measured_gflops": float(cand.tile + cand.overlap), "verified": True}

    cfg = autotune.best_stencil_config(L=8, hosts=2, cache_directory=str(tmp_path),
                                       measure_fn=stub, hw=HW, device="cpu")
    assert cfg["variant"] == "cuda_stencil" and not cfg["cached"]
    prov = cfg["stencil"]
    assert prov["hosts"] == 2 and prov["schema"] == autotune.SCHEMA_VERSION
    assert prov["candidates_measured"] <= math.ceil(0.5 * prov["candidates_total"])
    # the schedule by the model among the best tile's rows: serial on one card
    assert (cfg["overlap"], cfg["depth"]) == (False, 1)
    again = autotune.best_stencil_config(L=8, hosts=2, cache_directory=str(tmp_path),
                                         device="cpu")
    assert again["cached"] and again["stencil"] == prov and again["tile"] == cfg["tile"]
    cache = autotune.load_cache(str(tmp_path))
    (key,) = cache
    assert "|soa-stencil-h2|" in key
    # neither validator serves the other's entries
    assert autotune._valid_cache_hit(cache[key]) is None
    assert autotune._valid_cg_hit(cache[key]) is None
    assert autotune._valid_stencil_hit(cache[key]) == {k: v for k, v in cfg.items()
                                                       if k != "cached"}


def test_best_stencil_config_tie_breaks_to_the_serial_schedule(tmp_path):
    cfg = autotune.best_stencil_config(
        L=4, hosts=1, cache=False, hw=HW, device="cpu", tiles=(64,), prune=1.0,
        measure_fn=lambda c: {"tile": c.tile, "overlap": c.overlap, "depth": c.depth,
                              "measured_gflops": 1.0 + c.depth + c.overlap, "verified": True})
    assert (cfg["overlap"], cfg["depth"], cfg["cached"]) == (False, 1, False)


# -- the CG model and tuner ---------------------------------------------------------------


def test_predict_cg_takes_the_ports_iteration_bytes():
    cfg = tplan.EngineConfig(L=8, tile=64)
    terms = roofline.cg_iteration_bound(cfg, HW)
    fused = autotune.predict_cg(autotune.CGCandidate(64, True), L=8, hw=HW)
    assert fused["bandwidth_bytes"] == terms["total"].bytes and fused["halo_s"] == 0.0
    words = (roofline.CG_EPILOGUE_WORDS_PER_SITE + roofline.GATHER_WORDS_PER_SITE
             + su3_stencil.STENCIL_WORDS_PER_SITE + 18)  # epilogue, one gather, kernel, axpy
    composed = autotune.predict_cg(autotune.CGCandidate(64, False), L=8, hw=HW)
    assert composed["bandwidth_bytes"] == words * 4 * 8**4
    split = autotune.predict_cg(autotune.CGCandidate(64, True), L=8, hosts=2, hw=HW)
    assert split["exchange_bytes"] == 2 * 2 * (2 * 2 * 1024) * 6 * 4  # r and p
    kernel = terms["kernel"].bound_s
    assert split["bound_s"] == pytest.approx(
        max(split["compute_s"], split["memory_s"], split["issue_s"], split["halo_s"])
        + 0.5 * kernel)


def test_cg_pruned_sweep_within_5pct_of_exhaustive():
    def measure(cand):
        pred = autotune.predict_cg(cand, L=8, hosts=2, hw=HW)["predicted_gflops"]
        return {"tile": cand.tile, "fused": cand.fused,
                "measured_gflops": _wiggle(pred, cand), "verified": True}

    full = autotune.cg_sweep(L=8, hosts=2, prune=1.0, measure_fn=measure, hw=HW, device="cpu")
    pruned = autotune.cg_sweep(L=8, hosts=2, prune=0.5, measure_fn=measure, hw=HW, device="cpu")
    assert full["candidates_total"] == 12 and pruned["candidates_measured"] == 6
    assert (max(r["measured_gflops"] for r in pruned["rows"])
            >= 0.95 * max(r["measured_gflops"] for r in full["rows"]))


@pytest.mark.parametrize("dtype,accum", [("float32", ""), ("bfloat16", "float32")])
def test_measure_cg_candidate_verifies_on_two_slabs(dtype, accum):
    for fused in (True, False):
        row = autotune.measure_cg_candidate(autotune.CGCandidate(64, fused), L=4, dtype=dtype,
                                            accum_dtype=accum, hosts=2, device="cpu")
        assert row["verified"] and row["measured_gflops"] > 0.0


def test_best_cg_config_persists_and_caches(tmp_path):
    def stub(cand):
        return {"tile": cand.tile, "fused": cand.fused,
                "measured_gflops": float(cand.tile) + (0.5 if cand.fused else 0.0),
                "verified": True}

    cfg = autotune.best_cg_config(L=8, hosts=2, cache_directory=str(tmp_path),
                                  measure_fn=stub, hw=HW, device="cpu")
    assert cfg["variant"] == "cuda_cg" and not cfg["cached"] and cfg["cg"]["hosts"] == 2
    measured = [c for c in autotune.enumerate_cg_candidates(device="cpu")]
    assert cfg["cg"]["candidates_total"] == len(measured)
    again = autotune.best_cg_config(L=8, hosts=2, cache_directory=str(tmp_path), device="cpu")
    assert again["cached"] and (again["tile"], again["fused"]) == (cfg["tile"], cfg["fused"])
    assert any("|soa-cg-h2|" in k for k in autotune.load_cache(str(tmp_path)))
    with pytest.raises(RuntimeError, match="no verified candidate"):
        autotune.best_cg_config(L=8, hosts=2, cache=False, hw=HW, device="cpu",
                                measure_fn=lambda c: dict(stub(c), verified=False))


# -- attribution ----------------------------------------------------------------------------


def _mk_records() -> list:
    """Synthetic spans: one multiply config, one overlapped schedule."""
    tr = Tracer()
    for _ in range(3):
        tr.add_span("dispatch", 0.0, 0.010, kind="multiply", L=4, tile=64, k=2,
                    dtype="float32", compression="none", live=4, flops=864.0 * 256 * 2 * 4)
    for _ in range(2):
        with tr.span("stencil.step", L=4, tile=64, overlap=True, depth=1, hosts=2,
                     dtype="float32", compression="none", flops=576.0 * 256):
            for phase in ("stencil.exchange", "stencil.interior", "stencil.boundary"):
                with tr.span(phase):
                    pass
    return tr.spans()


def test_attribution_joins_measured_against_the_ports_model():
    rows = attribution_report(_mk_records(), hw=HW)
    by_wl = {r["workload"]: r for r in rows}
    mult = by_wl["multiply"]
    assert mult["n_spans"] == 3 and mult["fused_k"] == 2
    assert mult["measured_unit_s"] == pytest.approx(0.030 / 24)
    want = autotune.predict_pipeline(autotune.PipelineCandidate(64, 2), L=4, hw=HW)
    assert mult["predicted_s"] == want["bound_s"] and mult["model_dominant"] == want["dominant"]
    sched = by_wl["stencil_schedule"]
    assert sched["hosts"] == 2 and sched["overlap"] is True
    assert set(sched["phase_s"]) == {"exchange", "interior", "boundary"}
    assert sched["measured_dominant_phase"] in sched["phase_s"]
    assert sched["model_terms"] is not None and "halo_s" in sched["model_terms"]
    assert sched["model_terms"]["halo_s"] > 0.0


def test_attribution_matches_the_reference_join_on_measured_fields():
    records = _mk_records()
    mine = {r["workload"]: r for r in attribution_report(records, hw=HW)}
    ref = {r["workload"]: r for r in jattribution.attribution_report(records)}
    assert set(mine) == set(ref)
    for wl, row in ref.items():
        for key in ("n_spans", "measured_s", "measured_unit_s", "measured_gflops", "L", "tile",
                    "depth", "phase_s", "measured_dominant_phase"):
            assert mine[wl].get(key) == row.get(key), (wl, key)


def test_attribution_round_trips_jsonl_and_renders(tmp_path):
    tr = Tracer()
    for s in _mk_records():
        tr._record(s)
    path = tmp_path / "t.jsonl"
    tr.to_jsonl(str(path))
    rows = attribution_report(load_jsonl(str(path)), hw=HW)
    assert {r["workload"] for r in rows} == {"multiply", "stencil_schedule"}
    text = render_attribution(rows)
    assert "multiply" in text and "L4/t64" in text and "ovl" in text and "h2" in text
    assert render_attribution([]).startswith("(no attributable")


def test_attribution_needs_a_card_spec(monkeypatch):
    monkeypatch.setattr(roofline, "current_hardware", lambda: None)
    with pytest.raises(LookupError, match="no Hopper spec"):
        attribution_report(_mk_records())


def test_overlap_efficiency_accounting():
    acct = overlap_efficiency_from_spans(_mk_records())
    assert acct["n_steps"] == 2
    assert set(acct["phase_s"]) == {"exchange", "interior", "boundary"}
    assert acct["sum_phases_s"] <= acct["traced_wall_s"]
    assert overlap_efficiency_from_spans([]) is None
    assert overlap_efficiency(2.0, 1.0) == 2.0 and overlap_efficiency(1.0, 0.0) == 0.0


def test_a_traced_multislab_step_attributes():
    plan = tplan.build_plan(tplan.EngineConfig(L=8, tile=64), MeshSpec(hosts=2).resolve("cpu"))
    u, v = plan.init_stencil_data()
    plan.tracer = Tracer()
    for depth in (1, 2):
        plan.stencil_step(depth=depth)(u, v)
    rows = attribution_report(plan.tracer.spans(), hw=HW)
    assert [(r["workload"], r["hosts"], r["depth"]) for r in rows] == [
        ("stencil_schedule", 2, 1), ("stencil_schedule", 2, 2)]
    assert set(rows[1]["phase_s"]) == {"exchange", "interior", "boundary", "ring"}
    assert all(r["predicted_s"] > 0 and r["measured_unit_s"] > 0 for r in rows)
    acct = overlap_efficiency_from_spans(plan.tracer.spans())
    assert acct["n_steps"] == 2 and np.isfinite(acct["sum_phases_s"])


# -- provenance -----------------------------------------------------------------------------


def test_provenance_block_is_complete():
    block = provenance_block()
    for key in REQUIRED_PROVENANCE_KEYS:
        assert key in block, key
    assert block["torch_version"] == torch.__version__
    assert block["autotune_cache_schema"] == autotune.SCHEMA_VERSION
    assert len(block["git_sha"]) == 40 or block["git_sha"] == "unknown"
    if not torch.cuda.is_available():
        assert (block["backend"], block["device_kind"], block["sm_count"]) == ("cpu", "cpu", None)


def test_provenance_problems_names_missing_and_drifted_keys():
    good = {"provenance": provenance_block()}
    assert provenance_problems(good) == []
    assert provenance_problems({}) == ["current artifact has no provenance block"]
    broken = {"provenance": dict(good["provenance"])}
    del broken["provenance"]["power_limit"]
    assert any("power_limit" in p for p in provenance_problems(broken))
    drifted = {"provenance": dict(good["provenance"], device_kind="NVIDIA H100 80GB HBM3")}
    probs = provenance_problems(drifted, good)
    assert len(probs) == 1 and "device_kind" in probs[0]
    assert provenance_problems(drifted, good, rebaseline_note="new card") == []
    stamped = {"provenance": dict(drifted["provenance"], rebaseline="new card")}
    assert provenance_problems(stamped, good) == []
