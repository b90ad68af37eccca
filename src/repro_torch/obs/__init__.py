"""repro_torch.obs — bounded serving statistics, the span tracer, run
provenance and model-vs-measured attribution.

  Reservoir / RunningStat   bounded streaming statistics (``stats.py``)
  Tracer / NULL_TRACER      nested-span flight recorder with JSONL and
                            Chrome trace-event exports (``tracer.py``)
  provenance_block          the run-identity stamp: git sha, torch and CUDA
                            versions, driver, card name, power limit and SM
                            count (``provenance.py``)
  attribution_report        measured dispatch and stencil-phase spans joined
                            against ``predict_pipeline`` / ``predict_stencil``
                            per config (``attribution.py``)
"""
from repro_torch.obs.attribution import (
    attribution_report,
    overlap_efficiency,
    overlap_efficiency_from_spans,
    render_attribution,
)
from repro_torch.obs.provenance import (
    REQUIRED_PROVENANCE_KEYS,
    provenance_block,
    provenance_problems,
)
from repro_torch.obs.stats import Reservoir, RunningStat
from repro_torch.obs.tracer import NULL_TRACER, Span, Tracer

__all__ = [
    "NULL_TRACER",
    "REQUIRED_PROVENANCE_KEYS",
    "Reservoir",
    "RunningStat",
    "Span",
    "Tracer",
    "attribution_report",
    "overlap_efficiency",
    "overlap_efficiency_from_spans",
    "provenance_block",
    "provenance_problems",
    "render_attribution",
]
