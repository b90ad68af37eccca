"""The multiply half of the port's autotune: the model, the pruned sweep,
the cache protocol, and the choice against the JAX reference's.

Measurements are injected (``measure_fn``) so the tests pin the protocol —
what is measured when, what is persisted, what survives a bad file — and
not timings.  With the same injected measurements and an exhaustive sweep,
the port picks the same (tile, fused_k) as the reference: selection is by
measured throughput in both, only the model that orders the candidates
differs (the reference's TPU model is not the port's).
"""
import json

import pytest

from repro.core import autotune as jautotune
from repro_torch.core import autotune, roofline
from repro_torch.core.su3.plan import EngineConfig

HW = roofline.H100_SXM


def _measure(calls: list, winner=(256, 4)):
    def fn(cand):
        calls.append((cand.tile, cand.fused_k))
        gf = 3.0 if (cand.tile, cand.fused_k) == winner else 1.0 + cand.fused_k * 0.01
        return {"tile": cand.tile, "fused_k": cand.fused_k, "measured_gflops": gf,
                "verified": True}
    return fn


def test_ops_per_site_counts_the_kernels_operations():
    assert autotune.ops_per_site() == 792  # 22 operations x 36 entries
    assert autotune.ops_per_site(compression="two_row") == 528  # rows 0/1 only
    assert autotune.ops_per_site("bfloat16", "float32") == 792
    assert autotune.ops_per_site("bfloat16") == 792 * 3  # a round after each


def test_predict_pipeline_terms_on_the_h100():
    p1 = autotune.predict_pipeline(autotune.PipelineCandidate(512, 1), 32, hw=HW)
    n = 32**4
    assert p1["memory_s"] == pytest.approx(576 * n / 3.35e12)
    assert p1["issue_s"] == pytest.approx(792 * n / 33.5e12 + autotune.LAUNCH_OVERHEAD_S)
    assert p1["dominant"] == "memory" and p1["bound_s"] == p1["memory_s"]
    p8 = autotune.predict_pipeline(autotune.PipelineCandidate(512, 8), 32, hw=HW)
    assert p8["dominant"] == "issue" and p8["predicted_gflops"] > p1["predicted_gflops"]
    # at a small lattice the launch dominates and deep chains amortize it
    s1 = autotune.predict_pipeline(autotune.PipelineCandidate(128, 1), 2, hw=HW)
    s8 = autotune.predict_pipeline(autotune.PipelineCandidate(128, 8), 2, hw=HW)
    assert s8["issue_s"] < s1["issue_s"]
    # an oversized tile pads: the padded sites are charged
    big = autotune.predict_pipeline(autotune.PipelineCandidate(4096, 1), 2, hw=HW)
    assert big["predicted_gflops"] < s1["predicted_gflops"]
    with pytest.raises(LookupError):
        autotune.predict_pipeline(autotune.PipelineCandidate(128, 1), 2, hw=None)


def test_pipeline_sweep_measures_the_top_fraction_by_the_model():
    calls = []
    sweep = autotune.pipeline_sweep(L=2, measure_fn=_measure(calls), hw=HW, device="cpu")
    total = len(autotune.DEFAULT_TILES) * len(autotune.DEFAULT_KS)
    assert sweep["candidates_total"] == total
    assert sweep["candidates_measured"] == len(calls) == total // 2
    preds = [r["predicted_gflops"] for r in sweep["rows"]]
    assert preds == sorted(preds, reverse=True)
    assert [r["predicted_rank"] for r in sweep["rows"]] == list(range(len(calls)))


def test_best_config_persists_and_second_call_measures_nothing(tmp_path):
    calls = []
    fn = _measure(calls, winner=(128, 8))
    first = autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW,
                                 device="cpu")
    n = len(calls)
    assert first["cached"] is False and (first["tile"], first["fused_k"]) == (128, 8)
    assert first["variant"] == "cuda" and first["pipeline"]["schema"] == autotune.SCHEMA_VERSION
    second = autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW,
                                  device="cpu")
    assert len(calls) == n and second["cached"] is True
    assert (second["tile"], second["fused_k"]) == (128, 8)
    autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW,
                         device="cpu", refresh=True)
    assert len(calls) == 2 * n
    # the cache file keys the port's device identity and schema
    cache = json.loads((tmp_path / autotune.CACHE_FILE).read_text())
    (key,) = cache
    assert key.startswith(f"v{autotune.SCHEMA_VERSION}|cpu|torch") and key.endswith("|L2|d1")


def test_corrupt_or_partial_cache_entries_remeasure(tmp_path):
    calls = []
    fn = _measure(calls)
    autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW, device="cpu")
    path = tmp_path / autotune.CACHE_FILE
    cache = json.loads(path.read_text())
    (key,) = cache
    del cache[key]["config"]["pipeline"]
    path.write_text(json.dumps(cache))
    n = len(calls)
    again = autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW,
                                 device="cpu")
    assert again["cached"] is False and len(calls) == 2 * n
    path.write_text("{not json")
    assert autotune.load_cache(str(tmp_path)) == {}


def test_cache_keys_isolate_dtype_accum_and_compression(tmp_path):
    fn = _measure([])
    for kw in ({}, {"accum_dtype": "float32"}, {"compression": "two_row"}):
        autotune.best_config(L=2, dtype="bfloat16" if kw.get("accum_dtype") else "float32",
                             cache_directory=str(tmp_path), measure_fn=fn, hw=HW,
                             device="cpu", **kw)
    keys = sorted(json.loads((tmp_path / autotune.CACHE_FILE).read_text()))
    assert len(keys) == 3
    assert any("|bfloat16+acc-float32|" in k for k in keys)
    assert any("|two_row|" in k for k in keys)


def test_tuned_engine_config_and_fused_k_read_the_cache(tmp_path, monkeypatch):
    fn = _measure([], winner=(256, 2))
    autotune.best_config(L=2, cache_directory=str(tmp_path), measure_fn=fn, hw=HW, device="cpu",
                         prune=1.0)
    cfg = autotune.tuned_engine_config(L=2, cache_directory=str(tmp_path), device="cpu")
    assert isinstance(cfg, EngineConfig) and (cfg.tile, cfg.variant) == (256, "cuda")
    assert autotune.tuned_fused_k(L=2, cache_directory=str(tmp_path), device="cpu") == 2
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    assert autotune.cache_dir() == str(tmp_path)
    monkeypatch.delenv(autotune.CACHE_ENV)
    assert autotune.cache_dir().endswith("build/repro_torch/autotune")


def test_measure_candidate_runs_the_fused_chain_on_the_cpu():
    row = autotune.measure_candidate(autotune.PipelineCandidate(16, 2), L=2, device="cpu")
    assert row["verified"] and row["measured_gflops"] > 0 and row["fused_k"] == 2


def test_exhaustive_choice_matches_reference(tmp_path, monkeypatch):
    """Same injected measurements, every candidate measured: the port and
    the reference keep the same (tile, fused_k)."""
    monkeypatch.setattr(jautotune, "kernel_instruction_model",
                        lambda dtype="float32", accum_dtype="", tile=256,
                        compression="none": (100.0, 50.0))
    jcalls, tcalls = [], []
    want = jautotune.best_config(L=2, cache_directory=str(tmp_path / "j"), prune=1.0,
                                 measure_fn=_measure(jcalls, winner=(1024, 2)))
    got = autotune.best_config(L=2, cache_directory=str(tmp_path / "t"), prune=1.0,
                               measure_fn=_measure(tcalls, winner=(1024, 2)), hw=HW,
                               device="cpu")
    assert sorted(tcalls) == sorted(jcalls)
    assert (got["tile"], got["fused_k"]) == (want["tile"], want["fused_k"]) == (1024, 2)
    assert got["compression"] == want["compression"] == "none"
