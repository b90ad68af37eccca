#!/usr/bin/env python
"""Render a trace of the port's ``obs.Tracer``: the span tree and the
model-against-measured attribution.

Reads either export format of the port's tracer, flat JSONL (one record a
line) or Chrome trace-event JSON (``{"traceEvents": [...]}``), and prints:

  1. the span tree, aggregated by name path (count, total, mean);
  2. the counters, if any were recorded;
  3. the overlap schedule's phase accounting, where the trace holds
     overlapped ``stencil.step`` spans (the efficiency needs an untraced
     wall);
  4. the attribution table: every traced serving dispatch and stencil
     schedule joined against the port's roofline model
     (``repro_torch.obs.attribution_report``) for a card's spec: ``--hw``,
     else the card the trace's provenance names, else the card this runs
     on.  Without any, the table is left out and the report says so.

    PYTHONPATH=src python scripts/torch/profile_dispatch.py --quick --trace build/dispatch.json
    PYTHONPATH=src python scripts/torch/trace_report.py build/dispatch.json

Exit code 0 iff the report rendered.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core import roofline
from repro_torch.obs import attribution_report, overlap_efficiency_from_spans, render_attribution
from repro_torch.obs.tracer import load_jsonl

PROVENANCE_KEYS = ("git_sha", "torch_version", "cuda_runtime", "backend", "device_kind",
                   "power_limit")


def load_records(path: str) -> tuple[list[dict], dict]:
    """(records, metadata) from a JSONL or Chrome trace-event file."""
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except json.JSONDecodeError:  # several lines: flat JSONL
        return load_jsonl(path), {}
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        # a JSONL file of one record parses as one object
        return ([payload] if isinstance(payload, dict) else []), {}
    records = []
    for ev in payload["traceEvents"]:
        args = dict(ev.get("args") or {})
        records.append({
            "type": "span", "name": ev.get("name", ""),
            "ts_s": ev.get("ts", 0.0) / 1e6, "dur_s": ev.get("dur", 0.0) / 1e6,
            "span_id": args.pop("span_id", None), "parent_id": args.pop("parent_id", None),
            "lane": ev.get("tid", 0), "attrs": args,
        })
    meta = dict(payload.get("otherData") or {})
    for name, value in (meta.pop("counters", None) or {}).items():
        records.append({"type": "counter", "name": name, "value": value})
    return records, meta


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def span_tree(records: list[dict]) -> list[str]:
    """Spans aggregated by name path (the parent chain), as an indented table."""
    spans = [r for r in records if r.get("type", "span") == "span"]
    by_id = {s["span_id"]: s for s in spans if s.get("span_id") is not None}

    def path(s: dict) -> tuple[str, ...]:
        names, seen = [], set()
        while s is not None and s["span_id"] not in seen:
            seen.add(s["span_id"])
            names.append(s["name"])
            s = by_id.get(s.get("parent_id"))
        return tuple(reversed(names))

    agg: dict[tuple[str, ...], list[float]] = {}
    for s in spans:
        agg.setdefault(path(s), []).append(float(s.get("dur_s", 0.0)))
    width = max((2 * (len(p) - 1) + len(p[-1]) for p in agg), default=4)
    header = f"{'span':<{width}}  {'count':>5}  {'total':>9}  {'mean':>9}"
    lines = [header, "-" * len(header)]
    for p in sorted(agg):
        durs = agg[p]
        label = "  " * (len(p) - 1) + p[-1]
        lines.append(f"{label:<{width}}  {len(durs):>5}  {_fmt_s(sum(durs)):>9}  "
                     f"{_fmt_s(sum(durs) / len(durs)):>9}")
    return lines


def card_spec(meta: dict, name: str = "") -> roofline.HardwareSpec | None:
    """``name``'s spec, else that of the card the trace's provenance names,
    else the current card's."""
    if name:
        return roofline.HARDWARE[name]
    kind = meta.get("device_kind")
    if kind:
        return roofline.hardware_for_device(kind)
    return roofline.current_hardware()


def report(path: str, hw_name: str = "") -> str:
    records, meta = load_records(path)
    spans = [r for r in records if r.get("type", "span") == "span"]
    counters = [r for r in records if r.get("type") == "counter"]
    out = [f"trace: {path}  ({len(spans)} spans)"]
    prov = ", ".join(f"{k}={meta[k]}" for k in PROVENANCE_KEYS if k in meta)
    if prov:
        out.append(f"provenance: {prov}")
    if meta.get("dropped_spans"):
        out.append(f"WARNING: flight recorder dropped {meta['dropped_spans']} spans "
                   f"(ring capacity)")
    out.append("")
    out.extend(span_tree(records) if spans else ["(no spans)"])
    if counters:
        out.append("")
        out.append("counters:")
        out.extend(f"  {c['name']} = {c['value']}" for c in counters)
    acct = overlap_efficiency_from_spans(records)
    if acct:
        out.append("")
        out.append(f"overlap schedule ({acct['n_steps']} steps): "
                   + "  ".join(f"{k}={_fmt_s(v)}" for k, v in acct["phase_s"].items())
                   + f"  sum={_fmt_s(acct['sum_phases_s'])}"
                   + f"  traced_wall={_fmt_s(acct['traced_wall_s'])}")
        out.append("  (efficiency = sum_phases / UNTRACED wall; traced walls "
                   "serialize at phase boundaries and cannot witness hiding)")
    out.append("")
    hw = card_spec(meta, hw_name)
    if hw is None:
        out.append("attribution: no card spec (the trace names none and this host has no "
                   "known card); pass --hw to join the spans against a model")
    else:
        out.append(f"attribution (measured vs the roofline of {hw.name}):")
        out.append(render_attribution(attribution_report(records, hw=hw)))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a .jsonl or Chrome trace-event .json of the port's Tracer")
    ap.add_argument("--hw", choices=sorted(roofline.HARDWARE), default="",
                    help="the card spec the attribution models (default: the trace's card)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.trace):
        print(f"trace_report: no trace at {args.trace!r}", file=sys.stderr)
        return 1
    print(report(args.trace, args.hw))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
