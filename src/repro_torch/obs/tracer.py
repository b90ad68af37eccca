"""Flight-recorder span tracer: nested spans, bounded ring, two exports.

Design constraints:

  * monotonic clock — ``time.perf_counter`` everywhere; wall-clock never
    enters a duration.
  * bounded memory — completed spans land in a ``deque(maxlen=capacity)``
    flight recorder; the oldest spans fall off and ``dropped`` counts them.
  * near-zero cost disabled — ``NULL_TRACER.span(...)`` returns one shared
    no-op context manager and allocates NO per-call objects (``**attrs``
    would build a dict, so the fast path is checked *before* attrs exist:
    callers guard hot-path instrumentation with ``if tracer.enabled``).
  * two exports from one record — flat JSONL (one span per line, greppable)
    and Chrome trace-event JSON (``{"traceEvents": [...]}``, complete "X"
    events in microseconds) loadable in chrome://tracing / Perfetto.

Span lanes map to Chrome ``tid``s: dispatch spans ride on ``lane=host``,
request-lifecycle spans on per-request lanes, so overlapping requests do
not fake nesting in the viewer.  Real parent/child nesting is the span
stack: ``tracer.span(...)`` context managers nest; retroactive spans
(``add_span``) attach to the stack top at insertion time unless an explicit
parent id is given.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Iterator

_CLOCK = time.perf_counter


class Span:
    """One completed (or in-flight) span on the monotonic clock."""

    __slots__ = ("name", "t0_s", "t1_s", "span_id", "parent_id", "lane", "attrs")

    def __init__(self, name: str, t0_s: float, span_id: int,
                 parent_id: int | None, lane: int, attrs: dict[str, Any]):
        self.name = name
        self.t0_s = t0_s
        self.t1_s = t0_s
        self.span_id = span_id
        self.parent_id = parent_id
        self.lane = lane
        self.attrs = attrs

    @property
    def dur_s(self) -> float:
        return self.t1_s - self.t0_s

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes mid-span (e.g. live/padded known post-coalesce)."""
        self.attrs.update(attrs)
        return self

    def as_dict(self) -> dict[str, Any]:
        return {
            "type": "span",
            "name": self.name,
            "ts_s": self.t0_s,
            "dur_s": self.dur_s,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "lane": self.lane,
            "attrs": self.attrs,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, dur={self.dur_s * 1e6:.1f}us, "
                f"id={self.span_id}, parent={self.parent_id})")


class _SpanContext:
    """Context manager pairing one Span with the tracer's nesting stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack.append(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        span = self._span
        span.t1_s = _CLOCK()
        stack = self._tracer._stack
        if stack and stack[-1] is span:
            stack.pop()
        else:  # tolerate out-of-order exits rather than corrupt the stack
            try:
                stack.remove(span)
            except ValueError:
                pass
        self._tracer._record(span)


class _NullSpan:
    """Shared do-nothing span: the disabled-tracer fast path.

    One module-level instance serves every ``span()``/``event()`` call on a
    disabled tracer — no Span, no dict, no context-manager object is
    allocated.  ``set()`` is a no-op so call sites need no branches.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Nested-span flight recorder with counters and bounded history.

    Single-threaded by design (the serving loop is a cooperative stepper);
    there is no lock on the ring or the span stack.
    """

    def __init__(self, enabled: bool = True, capacity: int = 8192):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.dropped = 0
        self.counters: dict[str, float] = {}
        self._ring: deque[Span] = deque(maxlen=self.capacity)
        self._stack: list[Span] = []
        self._next_id = 1

    # ---------------------------------------------------------------- record
    def span(self, name: str, lane: int = 0, **attrs: Any):
        """Open a nested span; use as ``with tracer.span("dispatch", ...)``.

        Returns the shared no-op span when disabled.  Hot paths should
        still guard with ``if tracer.enabled`` so ``**attrs`` packing is
        skipped entirely.
        """
        if not self.enabled:
            return _NULL_SPAN
        parent = self._stack[-1].span_id if self._stack else None
        if self._stack and lane == 0:
            lane = self._stack[-1].lane
        span = Span(name, _CLOCK(), self._alloc_id(), parent, lane, attrs)
        return _SpanContext(self, span)

    def add_span(self, name: str, t0_s: float, t1_s: float, lane: int = 0,
                 parent_id: int | None = None, **attrs: Any) -> Span | None:
        """Record a retroactively-timed span (caller already holds t0/t1).

        This is the zero-overhead pattern for hot paths that time a block
        anyway (dispatch loops, profilers): measure as before, then emit
        one span after the fact under ``if tracer.enabled``.
        """
        if not self.enabled:
            return None
        if parent_id is None and self._stack:
            parent_id = self._stack[-1].span_id
        span = Span(name, t0_s, self._alloc_id(), parent_id, lane, attrs)
        span.t1_s = t1_s
        self._record(span)
        return span

    def event(self, name: str, lane: int = 0, **attrs: Any) -> Span | None:
        """Zero-duration marker (admit, seat, evict...)."""
        if not self.enabled:
            return None
        now = _CLOCK()
        return self.add_span(name, now, now, lane=lane, **attrs)

    def absorb(self, records: list[dict[str, Any]], lane_offset: int = 0) -> int:
        """Merge span records from ANOTHER tracer (e.g. a forced-device
        subprocess's JSONL) into this ring, remapping span ids so parent /
        child links survive and cannot collide with local ids.

        Timestamps are kept on the source's monotonic clock — absolute
        offsets between processes are meaningless, but durations and
        nesting are exact.  Returns the number of spans absorbed.
        """
        if not self.enabled:
            return 0
        spans = [r for r in records if r.get("type", "span") == "span"]
        # two passes: children land in a ring BEFORE their parents (they
        # exit first), so parent ids are forward references
        idmap = {rec["span_id"]: self._alloc_id() for rec in spans
                 if rec.get("span_id") is not None}
        for rec in spans:
            span = Span(rec["name"], rec["ts_s"],
                        idmap.get(rec.get("span_id"), self._alloc_id()),
                        idmap.get(rec.get("parent_id")),
                        rec.get("lane", 0) + lane_offset,
                        dict(rec.get("attrs") or {}))
            span.t1_s = rec["ts_s"] + rec["dur_s"]
            self._record(span)
        return len(spans)

    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def _alloc_id(self) -> int:
        i = self._next_id
        self._next_id = i + 1
        return i

    def _record(self, span: Span) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(span)

    # ---------------------------------------------------------------- read
    def spans(self) -> list[Span]:
        """Completed spans, oldest first (bounded by ``capacity``)."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._stack.clear()
        self.counters.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    # ---------------------------------------------------------------- export
    def iter_records(self) -> Iterator[dict[str, Any]]:
        for span in self._ring:
            yield span.as_dict()
        for name, value in sorted(self.counters.items()):
            yield {"type": "counter", "name": name, "value": value}

    def to_jsonl(self, path: str) -> int:
        """Flat JSONL: one record per line. Returns the record count."""
        n = 0
        with open(path, "w") as fh:
            for rec in self.iter_records():
                fh.write(json.dumps(rec) + "\n")
                n += 1
        return n

    def chrome_trace(self, metadata: dict[str, Any] | None = None) -> dict:
        """Chrome trace-event JSON object (phase-X complete events, us)."""
        events = []
        for span in self._ring:
            events.append({
                "name": span.name,
                "cat": span.name.split(".", 1)[0],
                "ph": "X",
                "ts": span.t0_s * 1e6,
                "dur": max(span.dur_s, 0.0) * 1e6,
                "pid": 0,
                "tid": span.lane,
                "args": dict(span.attrs, span_id=span.span_id,
                             parent_id=span.parent_id),
            })
        out: dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
        other: dict[str, Any] = {"dropped_spans": self.dropped}
        if self.counters:
            other["counters"] = dict(self.counters)
        if metadata:
            other.update(metadata)
        out["otherData"] = other
        return out

    def to_chrome_trace(self, path: str,
                        metadata: dict[str, Any] | None = None) -> int:
        payload = self.chrome_trace(metadata=metadata)
        with open(path, "w") as fh:
            json.dump(payload, fh)
        return len(payload["traceEvents"])


NULL_TRACER = Tracer(enabled=False, capacity=0)


def load_jsonl(path: str) -> list[dict[str, Any]]:
    """Read a flat-JSONL trace back into record dicts (spans + counters)."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records
