"""Request-lifecycle robustness: structured failures, retry policy, host
health.

The contract this module pins for the serving stack: a request
that enters :class:`~repro_torch.serve.su3.service.SU3Service` leaves it in
exactly one of three ways — a result, a structured error, or a structured
timeout.  Nothing is silently dropped, nothing hangs.  The pieces:

  structured failures   :class:`RequestFailure` subclasses delivered
                        *through the result channel* (``pop_result`` /
                        ``pop_ready`` return them; ``arun`` raises them),
                        so synchronous steppers and asyncio callers see
                        the same taxonomy;
  RetryPolicy           capped exponential backoff with jitter and a
                        service-wide retry *budget* — a failing host
                        cannot convert the whole queue into an unbounded
                        retry storm;
  HostHealth            per-host consecutive-failure tracker fed by both
                        injected (repro_torch.chaos) and real failures; crossing
                        ``quarantine_after`` quarantines the host, and the
                        service re-seats its requests onto healthy pools
                        (the last rung of the degradation ladder).

Priorities: load shedding under backpressure is priority-aware — bulk
multiplies shed before latency-sensitive solves (the first step toward
the ROADMAP's SLO classes).  ``PRIORITY`` maps request kinds to that
order; higher sheds later.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any

# kind -> shedding priority: higher = more latency-sensitive = shed last.
# Solves are the flagship interactive workload; multiplies are the bulk tier.
PRIORITY = {"multiply": 0, "stencil": 1, "solve": 2}


class RequestFailure(RuntimeError):
    """Base of every structured per-request failure the service delivers.

    Instances ride the result channel: ``has_result`` turns True, a
    stepping caller gets the exception *object* from ``pop_result`` (check
    ``isinstance(out, RequestFailure)``), an ``arun`` caller gets it
    raised.  ``req_id``/``kind``/``attempts`` make every failure
    attributable without parsing the message.
    """

    def __init__(self, message: str, *, req_id: int, kind: str,
                 attempts: int = 0):
        super().__init__(message)
        self.req_id = req_id
        self.kind = kind
        self.attempts = attempts


class DeadlineExceededError(RequestFailure):
    """The request's deadline passed while queued or seated; it was evicted
    (queue slot and any live chain/slot-table seat freed).  ``partial``
    carries the best iterate for solves evicted mid-CG (None otherwise)."""

    def __init__(self, *, req_id: int, kind: str, deadline_s: float,
                 waited_s: float, attempts: int = 0, partial: Any = None):
        super().__init__(
            f"request {req_id} ({kind}) exceeded its {deadline_s:.3f}s "
            f"deadline after {waited_s:.3f}s",
            req_id=req_id, kind=kind, attempts=attempts,
        )
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.partial = partial


class RetriesExhaustedError(RequestFailure):
    """Every allowed retry failed (or the service-wide retry budget ran
    dry).  ``cause`` is the last failure's short reason string."""

    def __init__(self, *, req_id: int, kind: str, attempts: int, cause: str,
                 budget_exhausted: bool = False):
        why = "retry budget exhausted" if budget_exhausted else \
            f"{attempts} attempts failed"
        super().__init__(
            f"request {req_id} ({kind}) gave up: {why} (last cause: {cause})",
            req_id=req_id, kind=kind, attempts=attempts,
        )
        self.cause = cause
        self.budget_exhausted = budget_exhausted


class LoadShedError(RequestFailure):
    """The request was shed from the queue to admit a higher-priority one
    under backpressure (bulk multiplies shed before solves) — or rejected
    at the door by the brownout ladder (``shed_for_kind="brownout"``).
    ``retry_after_s > 0`` is a Retry-After hint: the service is browning
    out and the caller should back off at least that long before
    resubmitting (rung 3 sets it; ordinary sheds leave it 0)."""

    def __init__(self, *, req_id: int, kind: str, priority: int,
                 shed_for_kind: str, attempts: int = 0,
                 retry_after_s: float = 0.0):
        hint = f"; retry after {retry_after_s:.3f}s" if retry_after_s else ""
        super().__init__(
            f"request {req_id} ({kind}, priority {priority}) shed under "
            f"backpressure for an arriving {shed_for_kind}{hint}",
            req_id=req_id, kind=kind, attempts=attempts,
        )
        self.priority = priority
        self.shed_for_kind = shed_for_kind
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with jitter plus a service-wide budget.

    ``backoff_s(attempt)`` grows ``base_s * 2**attempt`` up to ``cap_s``,
    then multiplies by ``1 + U[0, jitter]`` from a seeded stream (decorrelates
    retry herds without losing reproducibility).  ``budget`` bounds TOTAL
    retries across the service lifetime: once spent, further failures turn
    into :class:`RetriesExhaustedError` immediately — the storm cannot
    amplify itself into an unbounded retry load.
    """

    max_retries: int = 3  # per-request attempt cap (beyond the first try)
    base_s: float = 0.002
    cap_s: float = 0.25
    jitter: float = 0.2  # multiplicative spread: delay *= 1 + U[0, jitter]
    budget: int = 256  # total retries the whole service may spend
    seed: int = 0  # jitter stream seed (reproducible backoff schedules)

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_s <= 0 or self.cap_s < self.base_s:
            raise ValueError(
                f"need 0 < base_s <= cap_s, got base_s={self.base_s} "
                f"cap_s={self.cap_s}"
            )
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        raw = min(self.base_s * (2.0 ** max(attempt - 1, 0)), self.cap_s)
        return raw * (1.0 + self.jitter * rng.random())


class HostHealth:
    """Per-host failure tracker and quarantine latch.

    Fed by every dispatch outcome — injected faults and real exceptions
    alike record a failure; a completed dispatch records a success and
    clears the consecutive count.  ``quarantine_after`` consecutive
    failures latch the host into quarantine: the router stops homing work
    there and the service re-seats its live requests onto healthy pools.
    ``reinstate`` is the explicit operator/probe path back in (the service
    never auto-heals a host it has seen fail repeatedly — a flapping host
    is worse than a missing one).
    """

    def __init__(self, n_hosts: int, quarantine_after: int = 3):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}"
            )
        self.n_hosts = n_hosts
        self.quarantine_after = quarantine_after
        self.failures = [0] * n_hosts  # lifetime totals
        self.successes = [0] * n_hosts
        self.consecutive = [0] * n_hosts
        self.last_cause: list[str] = [""] * n_hosts
        self._quarantined: set[int] = set()

    def record_failure(self, host: int, cause: str) -> bool:
        """Account one failure; returns True iff this crossing quarantined
        the host (the caller re-seats its work exactly once)."""
        self.failures[host] += 1
        self.consecutive[host] += 1
        self.last_cause[host] = cause
        if (host not in self._quarantined
                and self.consecutive[host] >= self.quarantine_after
                and self.n_hosts - len(self._quarantined) > 1):
            # quarantining must leave a healthy host to re-seat onto: a
            # single-host service (or the last healthy host) keeps
            # retrying/degrading instead of quarantining itself to death
            self._quarantined.add(host)
            return True
        return False

    def record_success(self, host: int) -> None:
        self.successes[host] += 1
        self.consecutive[host] = 0

    def quarantined(self) -> set[int]:
        return set(self._quarantined)

    def is_quarantined(self, host: int) -> bool:
        return host in self._quarantined

    def healthy_hosts(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self._quarantined]

    def reinstate(self, host: int) -> None:
        """Operator/probe path: clear the latch and the consecutive count."""
        self._quarantined.discard(host)
        self.consecutive[host] = 0

    def snapshot(self) -> dict[str, Any]:
        return {
            "failures": list(self.failures),
            "successes": list(self.successes),
            "consecutive": list(self.consecutive),
            "quarantined": sorted(self._quarantined),
            "last_cause": list(self.last_cause),
        }
