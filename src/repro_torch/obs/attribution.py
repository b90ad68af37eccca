"""Model-vs-measured attribution: join spans against the roofline terms
(port of ``repro.obs.attribution``).

For every config that ran — (tile, fused_k, compression, depth, hosts) —
line up the measured span time against the port's prediction
(``autotune.predict_pipeline`` / ``autotune.predict_stencil``) and report
the difference: "this schedule is memory-bound and the model under-predicts
it by 40 %", not one GFLOPS number.

Span contract (what the serving stack and the plan emit):

  ``dispatch``      attrs: kind ("multiply" | "stencil"), L, tile, k, dtype,
                    compression, host, live, flops.  One span per host-step
                    dispatch; ``flops`` are the useful flops of the live
                    requests in the batch.
  ``stencil.step``  attrs: L, tile, dtype, compression, hosts, overlap,
                    depth, flops.  Child spans ``stencil.exchange`` /
                    ``stencil.interior`` / ``stencil.boundary`` (and
                    ``stencil.ring`` at depth 2) carry the phase times that
                    make ``overlap_efficiency`` a measured quantity.

Rows accept live ``Span`` objects or JSONL record dicts alike.  The model
needs a card's spec: ``hw`` defaults to CUDA device 0's
(``roofline.current_hardware()``), and without one the report raises, as
the predictors do.
"""
from __future__ import annotations

import statistics
from typing import Any, Iterable

from repro_torch.core import roofline

_PHASE_NAMES = ("stencil.exchange", "stencil.interior", "stencil.boundary", "stencil.ring")


def _norm(rec: Any) -> dict[str, Any] | None:
    """Span | JSONL record -> {name, dur_s, attrs, span_id, parent_id}."""
    if hasattr(rec, "as_dict"):
        rec = rec.as_dict()
    if not isinstance(rec, dict) or rec.get("type", "span") != "span":
        return None
    return {
        "name": rec.get("name", ""),
        "dur_s": float(rec.get("dur_s", 0.0)),
        "attrs": rec.get("attrs", {}) or {},
        "span_id": rec.get("span_id"),
        "parent_id": rec.get("parent_id"),
    }


def _spans(records: Iterable[Any]) -> list[dict[str, Any]]:
    return [n for n in (_norm(r) for r in records) if n is not None]


# --------------------------------------------------------------------- joins
def _multiply_rows(spans: list[dict], autotune, hw) -> list[dict]:
    groups: dict[tuple, list[dict]] = {}
    for s in spans:
        a = s["attrs"]
        if s["name"] != "dispatch" or a.get("kind") != "multiply":
            continue
        key = (int(a.get("L", 0)), int(a.get("tile", 0)), int(a.get("k", 1)),
               str(a.get("dtype", "float32")), str(a.get("compression", "none")))
        groups.setdefault(key, []).append(s)
    rows = []
    for (L, tile, k, dtype, compression), members in sorted(groups.items()):
        durs = [m["dur_s"] for m in members if m["dur_s"] > 0]
        flops = sum(float(m["attrs"].get("flops", 0.0)) for m in members)
        total_s = sum(m["dur_s"] for m in members)
        mults = sum(int(m["attrs"].get("live", 1)) for m in members) * k
        unit_s = total_s / mults if mults else 0.0
        row = {
            "workload": "multiply",
            "L": L, "tile": tile, "fused_k": k,
            "dtype": dtype, "compression": compression, "depth": None,
            "n_spans": len(members),
            "measured_s": statistics.median(durs) if durs else 0.0,
            "measured_unit_s": unit_s,
            "measured_gflops": (flops / total_s / 1e9) if total_s else 0.0,
        }
        pred = None
        if tile > 0 and L > 0:
            pred = autotune.predict_pipeline(
                autotune.PipelineCandidate(tile=tile, fused_k=k),
                L=L, dtype=dtype, hw=hw, compression=compression)
        row.update(_model_fields(pred, unit_s))
        rows.append(row)
    return rows


def _stencil_dispatch_rows(spans: list[dict], autotune, hw) -> list[dict]:
    groups: dict[tuple, list[dict]] = {}
    for s in spans:
        a = s["attrs"]
        if s["name"] != "dispatch" or a.get("kind") != "stencil":
            continue
        key = (int(a.get("L", 0)), int(a.get("tile", 0)),
               str(a.get("dtype", "float32")), str(a.get("compression", "none")))
        groups.setdefault(key, []).append(s)
    rows = []
    for (L, tile, dtype, compression), members in sorted(groups.items()):
        durs = [m["dur_s"] for m in members if m["dur_s"] > 0]
        flops = sum(float(m["attrs"].get("flops", 0.0)) for m in members)
        total_s = sum(m["dur_s"] for m in members)
        apps = sum(int(m["attrs"].get("live", 1)) * int(m["attrs"].get("k", 1))
                   for m in members)
        unit_s = total_s / apps if apps else 0.0
        row = {
            "workload": "stencil",
            "L": L, "tile": tile, "fused_k": None,
            "dtype": dtype, "compression": compression, "depth": 1,
            "n_spans": len(members),
            "measured_s": statistics.median(durs) if durs else 0.0,
            "measured_unit_s": unit_s,
            "measured_gflops": (flops / total_s / 1e9) if total_s else 0.0,
        }
        pred = None
        if tile > 0 and L > 0:
            pred = autotune.predict_stencil(
                autotune.StencilCandidate(tile=tile, overlap=False, depth=1),
                L=L, dtype=dtype, hosts=1, hw=hw, compression=compression)
        row.update(_model_fields(pred, unit_s))
        rows.append(row)
    return rows


def _stencil_schedule_rows(spans: list[dict], autotune, hw) -> list[dict]:
    """One row per traced (L, tile, overlap, depth, hosts, dtype,
    compression) schedule, with per-phase seconds from its child spans."""
    by_id = {s["span_id"]: s for s in spans if s["span_id"] is not None}
    steps: dict[tuple, list[dict]] = {}
    phases: dict[int, dict[str, float]] = {}
    for s in spans:
        if s["name"] == "stencil.step":
            a = s["attrs"]
            key = (int(a.get("L", 0)), int(a.get("tile", 0)),
                   bool(a.get("overlap", False)), int(a.get("depth", 1)),
                   int(a.get("hosts", 1)), str(a.get("dtype", "float32")),
                   str(a.get("compression", "none")))
            steps.setdefault(key, []).append(s)
        elif s["name"] in _PHASE_NAMES and s["parent_id"] in by_id:
            acc = phases.setdefault(s["parent_id"], {})
            short = s["name"].split(".", 1)[1]
            acc[short] = acc.get(short, 0.0) + s["dur_s"]
    rows = []
    for (L, tile, overlap, depth, hosts, dtype, compression), members in sorted(steps.items()):
        durs = [m["dur_s"] for m in members if m["dur_s"] > 0]
        measured_s = statistics.median(durs) if durs else 0.0
        unit_s = measured_s / max(depth, 1)  # a depth-d step is d applications
        phase_s: dict[str, float] = {}
        n_phase_steps = 0
        for m in members:
            p = phases.get(m["span_id"])
            if p:
                n_phase_steps += 1
                for name, dur in p.items():
                    phase_s[name] = phase_s.get(name, 0.0) + dur
        if n_phase_steps:
            phase_s = {k: v / n_phase_steps for k, v in phase_s.items()}
        flops = sum(float(m["attrs"].get("flops", 0.0)) for m in members)
        total_s = sum(m["dur_s"] for m in members)
        row = {
            "workload": "stencil_schedule",
            "L": L, "tile": tile, "fused_k": None,
            "dtype": dtype, "compression": compression,
            "overlap": overlap, "depth": depth, "hosts": hosts,
            "n_spans": len(members),
            "measured_s": measured_s,
            "measured_unit_s": unit_s,
            "measured_gflops": (flops / total_s / 1e9) if total_s else 0.0,
            "phase_s": {k: round(v, 9) for k, v in sorted(phase_s.items())},
            "measured_dominant_phase": max(phase_s, key=phase_s.get) if phase_s else None,
        }
        pred = None
        if tile > 0 and L > 0:
            pred = autotune.predict_stencil(
                autotune.StencilCandidate(tile=tile, overlap=overlap, depth=depth),
                L=L, dtype=dtype, hosts=hosts, hw=hw, compression=compression)
        row.update(_model_fields(pred, unit_s))
        rows.append(row)
    return rows


def _model_fields(pred: dict | None, measured_unit_s: float) -> dict:
    """The model side of a row: the predicted terms and the headline delta,
    ``(measured - predicted) / predicted`` on the per-unit time (positive:
    the model under-predicts, the card is slower)."""
    if not pred:
        return {"predicted_s": None, "predicted_gflops": None, "model_dominant": None,
                "model_terms": None, "delta_frac": None}
    bound = float(pred["bound_s"])
    terms = {k: pred[k] for k in ("compute_s", "memory_s", "issue_s", "halo_s") if k in pred}
    return {
        "predicted_s": bound,
        "predicted_gflops": pred.get("predicted_gflops"),
        "model_dominant": pred.get("dominant"),
        "model_terms": terms,
        "delta_frac": ((measured_unit_s - bound) / bound) if bound else None,
    }


def attribution_report(records: Iterable[Any],
                       hw: roofline.HardwareSpec | None = None) -> list[dict]:
    """Measured-vs-modeled rows for every config that shows up in spans.

    Three workload families: ``multiply`` (serving dispatches, joined with
    ``predict_pipeline``), ``stencil`` (serving dispatches,
    ``predict_stencil`` serial on one slab), ``stencil_schedule`` (the
    plan's ``stencil.step`` spans and their phases, ``predict_stencil`` at
    the traced overlap, depth and hosts).

    Raises:
        LookupError: no ``hw`` is given and the card is unknown.
    """
    # imported here: the plan imports this package (for its tracer), and
    # the predictors import the plan
    from repro_torch.core import autotune

    hw = hw if hw is not None else roofline.current_hardware()
    if hw is None:
        raise LookupError("no Hopper spec for this device; pass hw= explicitly")
    spans = _spans(records)
    return (_multiply_rows(spans, autotune, hw) + _stencil_dispatch_rows(spans, autotune, hw)
            + _stencil_schedule_rows(spans, autotune, hw))


# ------------------------------------------------------------ overlap measure
def overlap_efficiency_from_spans(records: Iterable[Any]) -> dict | None:
    """Phase accounting of the overlap schedule, from its spans: the mean
    per-step phase seconds and the traced wall.

    A traced run synchronizes at phase boundaries (the only way to time a
    phase), so its wall cannot show hiding: the caller divides
    ``sum_phases_s`` by an UNTRACED wall of the same step
    (:func:`overlap_efficiency`; 1.0 hides nothing, above 1 the exchange
    overlapped the interior pass).
    """
    spans = _spans(records)
    steps = [s for s in spans if s["name"] == "stencil.step" and s["attrs"].get("overlap")]
    if not steps:
        return None
    ids = {s["span_id"] for s in steps}
    phase_s: dict[str, float] = {}
    for s in spans:
        if s["name"] in _PHASE_NAMES and s["parent_id"] in ids:
            short = s["name"].split(".", 1)[1]
            phase_s[short] = phase_s.get(short, 0.0) + s["dur_s"]
    n = len(steps)
    phase_s = {k: v / n for k, v in phase_s.items()}
    return {
        "n_steps": n,
        "phase_s": {k: round(v, 9) for k, v in sorted(phase_s.items())},
        "sum_phases_s": sum(phase_s.values()),
        "traced_wall_s": sum(s["dur_s"] for s in steps) / n,
    }


def overlap_efficiency(sum_phases_s: float, untraced_wall_s: float) -> float:
    """Summed phase seconds over the untraced wall (0.0 for no wall)."""
    if untraced_wall_s <= 0:
        return 0.0
    return sum_phases_s / untraced_wall_s


# ---------------------------------------------------------------- rendering
_COLUMNS = ("workload", "config", "n", "measured", "modeled", "delta", "dominant",
            "gflops(meas/pred)")


def _fmt_s(v: float | None) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def _config_tag(row: dict) -> str:
    bits = [f"L{row['L']}", f"t{row['tile']}"]
    if row.get("fused_k"):
        bits.append(f"k{row['fused_k']}")
    if row.get("depth") and row["workload"] != "multiply":
        bits.append(f"d{row['depth']}")
    if row.get("hosts", 1) > 1:
        bits.append(f"h{row['hosts']}")
    if row.get("overlap"):
        bits.append("ovl")
    if row.get("compression", "none") != "none":
        bits.append(row["compression"])
    if row.get("dtype", "float32") != "float32":
        bits.append(row["dtype"])
    return "/".join(bits)


def render_attribution(rows: list[dict]) -> str:
    """Fixed-width model-vs-measured table."""
    if not rows:
        return "(no attributable dispatch/schedule spans in trace)"
    table = [_COLUMNS]
    for row in rows:
        delta = row.get("delta_frac")
        meas_g, pred_g = row.get("measured_gflops"), row.get("predicted_gflops")
        dominant = row.get("model_dominant") or "-"
        if row.get("measured_dominant_phase"):
            dominant += f" (meas: {row['measured_dominant_phase']})"
        table.append((
            row["workload"],
            _config_tag(row),
            str(row["n_spans"]),
            _fmt_s(row.get("measured_unit_s")),
            _fmt_s(row.get("predicted_s")),
            f"{delta:+.0%}" if delta is not None else "-",
            dominant,
            f"{meas_g:.2f}/{pred_g:.2f}" if meas_g is not None and pred_g is not None else "-",
        ))
    widths = [max(len(r[i]) for r in table) for i in range(len(_COLUMNS))]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
