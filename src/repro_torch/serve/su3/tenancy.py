"""Multi-tenant SLO scheduling: quotas, fairness, autoscaling, brownout.

The paper's lesson generalized to traffic: SU3_Bench saturates
whichever pipeline resource binds first — and a shared serving stack dies
the same way, except the casualty is another tenant's p99.  This module is
the control plane that keeps one tenant's burst from becoming everyone's
tail latency.  Pure host-side scheduling state — no torch — so every policy
is unit-testable without a device:

  SLO classes       two lanes: ``latency`` (preempting, never shed) and
                    ``bulk`` (preemptible, the only sheddable lane).  Each
                    request kind has a default class (multiplies are bulk;
                    stencils and solves are the interactive tier) that
                    ``submit_*(slo=...)`` overrides per request.
  TenantQuota       token-bucket admission rate per tenant: ``burst``
                    tokens of headroom refilled at ``rate_per_s``.  A
                    tenant past its bucket is rejected at the front door
                    before it can queue against anyone else.  ``rate_per_s
                    = 0`` makes the bucket a pure burst budget — fully
                    deterministic, what the reproducible benches use.
  DeficitFairScheduler
                    deficit-weighted round robin over ``(tenant, class)``
                    groups, replacing the global kind rotation: every
                    pending group accrues ``quantum x weight`` credit per
                    visit and is served when it covers one turn, so a
                    backlogged bulk tenant cannot monopolize turns and a
                    lone latency tenant is served within a provable bound
                    (tested: a continuously-pending group is served within
                    ``ceil(1/(quantum x weight))`` ring passes, each pass
                    costing at most ``sum(ceil(1 + quantum x weight_h))``
                    turns over the other groups).
  WarmPoolAutoscaler
                    grow/shrink the ACTIVE host-submesh pool set from
                    queue-depth/occupancy pressure with hysteresis
                    (``grow_turns`` hot observations to add a host,
                    ``shrink_turns`` cold ones to retire the top host).
                    The service vetoes any shrink that would evict a
                    seated latency request.
  BrownoutLadder    three overload rungs entered on SUSTAINED pressure and
                    exited with hysteresis: rung 1 sheds bulk admissions
                    past a reduced queue share, rung 2 additionally
                    degrades bulk solves (fewer CG iterations per turn,
                    bf16 plans where a warm pool entry exists), rung 3
                    rejects new bulk outright with a ``Retry-After`` hint
                    in the LoadShedError.  Transitions are keyed by
                    observation index — not wall clock — so a same-seed
                    replay reproduces the transition log bit-for-bit.

Latency-class work is protected three ways, in escalating order: fair
turns (the scheduler), seats (latency preempts the youngest bulk seat via
the service's re-seating machinery), and admission (brownout only ever
sheds the bulk lane).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

DEFAULT_TENANT = "default"

SLO_LATENCY = "latency"
SLO_BULK = "bulk"
SLO_CLASSES = (SLO_LATENCY, SLO_BULK)

# request kind -> default SLO class: solves/stencils are the interactive
# tier (mirrors robustness.PRIORITY, where multiplies shed first);
# submit_*(slo=...) overrides per request.
DEFAULT_KIND_SLO = {
    "multiply": SLO_BULK,
    "stencil": SLO_LATENCY,
    "solve": SLO_LATENCY,
}

GroupKey = tuple[str, str]  # (tenant, SLO class)


def class_key(tenant: str, slo: str) -> str:
    """The flat ``tenant/class`` key metrics snapshots export."""
    return f"{tenant}/{slo}"


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Per-class serving policy: deadline defaults and scheduler weights.

    ``*_deadline_s`` is the relative deadline a request of that class gets
    when it passes none of its own (0 = fall through to the service-wide
    ``default_deadline_s``).  ``*_weight`` is the class's share of fair
    turns: with the defaults a latency group earns 4 turns for every bulk
    turn when both are backlogged.
    """

    latency_deadline_s: float = 0.0
    bulk_deadline_s: float = 0.0
    latency_weight: float = 4.0
    bulk_weight: float = 1.0

    def __post_init__(self) -> None:
        if self.latency_deadline_s < 0 or self.bulk_deadline_s < 0:
            raise ValueError(
                f"class deadlines must be >= 0, got latency="
                f"{self.latency_deadline_s} bulk={self.bulk_deadline_s}"
            )
        if self.latency_weight <= 0 or self.bulk_weight <= 0:
            raise ValueError(
                f"class weights must be > 0, got latency="
                f"{self.latency_weight} bulk={self.bulk_weight}"
            )

    def deadline_for(self, slo: str) -> float:
        return self.latency_deadline_s if slo == SLO_LATENCY \
            else self.bulk_deadline_s

    def weight_for(self, group: GroupKey) -> float:
        return self.latency_weight if group[1] == SLO_LATENCY \
            else self.bulk_weight


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Token-bucket spec for one tenant: ``burst`` tokens of headroom,
    refilled at ``rate_per_s``.  ``rate_per_s = 0`` never refills — the
    bucket is a pure burst budget, deterministic under replay."""

    rate_per_s: float = 0.0
    burst: float = 8.0

    def __post_init__(self) -> None:
        if self.rate_per_s < 0:
            raise ValueError(f"rate_per_s must be >= 0, got {self.rate_per_s}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


class TokenBucket:
    """Runtime state of one tenant's :class:`TenantQuota` (the spec stays
    frozen in the config; every service instance meters independently)."""

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self._tokens = float(quota.burst)
        self._last_s: float | None = None

    @property
    def tokens(self) -> float:
        return self._tokens

    def try_take(self, now: float, n: float = 1.0) -> bool:
        """Spend ``n`` tokens at time ``now``; False when the bucket is dry
        (the caller rejects the submit — quota backpressure)."""
        if self._last_s is not None and self.quota.rate_per_s > 0:
            elapsed = max(0.0, now - self._last_s)
            self._tokens = min(
                float(self.quota.burst),
                self._tokens + elapsed * self.quota.rate_per_s,
            )
        self._last_s = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class DeficitFairScheduler:
    """Deficit-weighted round robin over ``(tenant, class)`` groups.

    Each ``next_group`` call serves ONE scheduling turn (cost 1.0).  Groups
    join a stable ring in first-seen order; a visited pending group accrues
    ``quantum x weight(group)`` deficit and is served once its deficit
    covers a turn, staying current until the grant is spent (so weights > 1
    buy consecutive turns, weights < 1 are served every few ring passes).
    A group observed idle forfeits its deficit — classic DRR, so an idle
    tenant cannot bank credit and burst past the others later.

    Non-starvation: a group with weight w needs ``ceil(1/(quantum x w))``
    ring visits to bank one turn, and between two of its visits every other
    group h can hold the floor for at most ``ceil(1 + quantum x weight(h))``
    consecutive turns (its deficit cap).  So while a group stays pending it
    is served at least once every ``ceil(1/(quantum x w)) x
    sum_h ceil(1 + quantum x weight(h))`` calls — the property test in
    tests/test_tenancy.py pins this bound.
    """

    def __init__(self, weight_for=None, quantum: float = 1.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.quantum = quantum
        self._weight_for = weight_for if weight_for is not None \
            else (lambda _g: 1.0)
        self._ring: list[GroupKey] = []  # stable first-seen order
        self._seen: set[GroupKey] = set()
        self._deficit: dict[GroupKey, float] = {}
        self._cursor = 0
        self._current: GroupKey | None = None
        self.turns: dict[GroupKey, int] = {}  # lifetime served-turn counts

    def _weight(self, group: GroupKey) -> float:
        w = float(self._weight_for(group))
        if w <= 0:
            raise ValueError(f"group weight must be > 0, got {w} for {group}")
        return w

    def next_group(self, pending: Iterable[GroupKey]) -> GroupKey | None:
        """The group that owns the next scheduling turn (None = idle)."""
        pend = list(dict.fromkeys(pending))
        pset = set(pend)
        for g in pend:
            if g not in self._seen:
                self._seen.add(g)
                self._ring.append(g)
        # DRR empty-queue rule: going idle forfeits banked credit
        for g in list(self._deficit):
            if g not in pset:
                del self._deficit[g]
        if not pend:
            self._current = None
            return None
        # stay on the current group while its grant covers another turn
        cur = self._current
        if cur in pset and self._deficit.get(cur, 0.0) >= 1.0:
            self._deficit[cur] -= 1.0
            self.turns[cur] = self.turns.get(cur, 0) + 1
            return cur
        # walk the ring: each visited pending group accrues one quantum
        min_w = min(self._weight(g) for g in pend)
        max_passes = max(1, math.ceil(1.0 / (self.quantum * min_w)))
        for _ in range(len(self._ring) * max_passes + len(self._ring)):
            g = self._ring[self._cursor % len(self._ring)]
            self._cursor += 1
            if g not in pset:
                continue
            grant = self.quantum * self._weight(g)
            # cap: one turn's cost plus one grant — idle groups already
            # forfeit, this bounds banked credit for always-pending ones
            self._deficit[g] = min(
                self._deficit.get(g, 0.0) + grant, 1.0 + grant
            )
            if self._deficit[g] >= 1.0:
                self._deficit[g] -= 1.0
                self._current = g
                self.turns[g] = self.turns.get(g, 0) + 1
                return g
        raise RuntimeError(
            "deficit scheduler failed to pick a pending group "
            f"(ring={self._ring}, pending={pend})"
        )  # pragma: no cover - the pass bound above makes this unreachable


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Warm-pool controller thresholds.  Disabled by default: the service
    keeps every configured host active, exactly the pre-tenancy behavior."""

    enabled: bool = False
    min_hosts: int = 1
    grow_queue_depth: int = 8  # queued backlog PER ACTIVE HOST that is hot
    grow_occupancy: float = 0.85  # mean seat occupancy that is hot
    shrink_queue_depth: int = 1  # backlog per active host that is cold
    shrink_occupancy: float = 0.25  # seat occupancy that is cold
    grow_turns: int = 2  # consecutive hot observations before growing
    shrink_turns: int = 6  # consecutive cold observations before shrinking

    def __post_init__(self) -> None:
        if self.min_hosts < 1:
            raise ValueError(f"min_hosts must be >= 1, got {self.min_hosts}")
        if self.grow_queue_depth <= self.shrink_queue_depth:
            raise ValueError(
                f"need grow_queue_depth > shrink_queue_depth for hysteresis, "
                f"got {self.grow_queue_depth} <= {self.shrink_queue_depth}"
            )
        if not 0.0 <= self.shrink_occupancy < self.grow_occupancy <= 1.0:
            raise ValueError(
                f"need 0 <= shrink_occupancy < grow_occupancy <= 1, got "
                f"{self.shrink_occupancy} / {self.grow_occupancy}"
            )
        if self.grow_turns < 1 or self.shrink_turns < 1:
            raise ValueError(
                f"grow/shrink_turns must be >= 1, got "
                f"{self.grow_turns}/{self.shrink_turns}"
            )


class WarmPoolAutoscaler:
    """Hysteresis controller over the active host-pool size.

    ``observe`` ingests one control-loop sample (aggregate queued backlog
    per active host + mean seat occupancy) and returns +1/-1/0: grow after
    ``grow_turns`` consecutive hot samples, shrink after ``shrink_turns``
    consecutive cold ones, hold otherwise.  The streak resets whenever the
    signal flips OR a decision fires, so scaling never oscillates on a
    boundary sample.  The SERVICE owns the active count (it must veto
    shrinks that would evict a seated latency request); this controller is
    pure decision state.
    """

    def __init__(self, cfg: AutoscaleConfig, max_hosts: int):
        if max_hosts < cfg.min_hosts:
            raise ValueError(
                f"max_hosts={max_hosts} below autoscale min_hosts="
                f"{cfg.min_hosts}"
            )
        self.cfg = cfg
        self.max_hosts = max_hosts
        self._hot = 0
        self._cold = 0

    def observe(self, *, depth_per_host: float, occupancy: float,
                active: int) -> int:
        """One control-loop sample; returns the proposed delta (+1/-1/0)."""
        cfg = self.cfg
        hot = (depth_per_host >= cfg.grow_queue_depth
               or occupancy >= cfg.grow_occupancy)
        cold = (depth_per_host <= cfg.shrink_queue_depth
                and occupancy <= cfg.shrink_occupancy)
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0
        if self._hot >= cfg.grow_turns and active < self.max_hosts:
            self._hot = 0
            return 1
        if self._cold >= cfg.shrink_turns and active > cfg.min_hosts:
            self._cold = 0
            return -1
        return 0


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Overload-ladder thresholds.  Pressure is the fraction of the active
    queue budget in use (queued depth / (max_queue_depth x active hosts)),
    blended with seat occupancy where seats exist; the ladder escalates one
    rung per ``sustain_turns`` consecutive pressured observations and steps
    down one rung per ``exit_turns`` consecutive calm ones — the dead band
    between ``exit_pressure`` and ``enter_pressure`` is the hysteresis."""

    enter_pressure: float = 0.75
    exit_pressure: float = 0.35
    sustain_turns: int = 3
    exit_turns: int = 6
    max_rung: int = 3
    bulk_queue_fraction: float = 0.5  # rung >= 1: bulk's share of the queue
    degrade_solve_factor: int = 2  # rung >= 2: solve_iters_per_step divisor
    degrade_bulk_bf16: bool = True  # rung >= 2: bulk solves ride a warm bf16
    # pool entry when one exists (never builds one mid-overload)
    retry_after_s: float = 0.05  # rung 3: Retry-After hint in LoadShedError

    def __post_init__(self) -> None:
        if not 0.0 <= self.exit_pressure < self.enter_pressure:
            raise ValueError(
                f"need 0 <= exit_pressure < enter_pressure (the hysteresis "
                f"band), got {self.exit_pressure} / {self.enter_pressure}"
            )
        if self.sustain_turns < 1 or self.exit_turns < 1:
            raise ValueError(
                f"sustain/exit_turns must be >= 1, got "
                f"{self.sustain_turns}/{self.exit_turns}"
            )
        if not 1 <= self.max_rung <= 3:
            raise ValueError(f"max_rung must be in [1, 3], got {self.max_rung}")
        if not 0.0 < self.bulk_queue_fraction <= 1.0:
            raise ValueError(
                f"bulk_queue_fraction must be in (0, 1], got "
                f"{self.bulk_queue_fraction}"
            )
        if self.degrade_solve_factor < 1:
            raise ValueError(
                f"degrade_solve_factor must be >= 1, got "
                f"{self.degrade_solve_factor}"
            )
        if self.retry_after_s < 0:
            raise ValueError(
                f"retry_after_s must be >= 0, got {self.retry_after_s}"
            )


class BrownoutLadder:
    """Three-rung overload state machine with hysteresis.

    Transitions are a function of the OBSERVATION SEQUENCE only (turn
    index, not wall clock), so a same-seed replay of the same traffic
    reproduces ``transitions`` exactly — the bench's reproducibility
    verdict diffs the two logs.
    """

    def __init__(self, cfg: BrownoutConfig):
        self.cfg = cfg
        self.rung = 0
        self.transitions: list[dict] = []  # {turn, from, to, pressure}
        self.rung_turns: dict[int, int] = {}  # rung -> observations spent
        self._turn = 0
        self._hot = 0
        self._calm = 0

    def observe(self, pressure: float) -> int | None:
        """Ingest one pressure sample; returns the new rung on a transition
        (None otherwise)."""
        self._turn += 1
        self.rung_turns[self.rung] = self.rung_turns.get(self.rung, 0) + 1
        if pressure >= self.cfg.enter_pressure:
            self._hot += 1
            self._calm = 0
        elif pressure <= self.cfg.exit_pressure:
            self._calm += 1
            self._hot = 0
        else:  # dead band: neither streak advances
            self._hot = 0
            self._calm = 0
        if self._hot >= self.cfg.sustain_turns and self.rung < self.cfg.max_rung:
            return self._move(self.rung + 1, pressure)
        if self._calm >= self.cfg.exit_turns and self.rung > 0:
            return self._move(self.rung - 1, pressure)
        return None

    def _move(self, to: int, pressure: float) -> int:
        self.transitions.append({
            "turn": self._turn, "from": self.rung, "to": to,
            "pressure": round(pressure, 4),
        })
        self.rung = to
        self._hot = 0
        self._calm = 0
        return to

    def signature(self) -> list[tuple[int, int, int]]:
        """The replay-comparable transition log: (turn, from, to)."""
        return [(t["turn"], t["from"], t["to"]) for t in self.transitions]
