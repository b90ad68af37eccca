"""repro_torch.obs — bounded serving statistics and the span tracer.

  Reservoir / RunningStat   bounded streaming statistics (``stats.py``)
  Tracer / NULL_TRACER      nested-span flight recorder with JSONL and
                            Chrome trace-event exports (``tracer.py``)
"""
from repro_torch.obs.stats import Reservoir, RunningStat
from repro_torch.obs.tracer import NULL_TRACER, Span, Tracer

__all__ = ["NULL_TRACER", "Reservoir", "RunningStat", "Span", "Tracer"]
