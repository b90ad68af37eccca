"""Serving metrics: the sustained-throughput view of the SU3 kernel.

The paper reports best-iteration GFLOPS of a dedicated loop; a service is
judged differently — by *sustained* useful throughput and tail latency under
a traffic mix.  This module owns that accounting so the service and the
traffic benchmark report identical quantities:

  latency      per-request wall seconds from admission to completion
               (p50/p95/p99 — the tail is what queueing and padding cost);
  gflops       useful flops only (864 x sites x chain depth per request,
               the paper's flop model) over busy time (kernel walls) and
               over total wall — padded slots are NOT credited;
  occupancy    live fraction of dispatched batch slots — the price of warm
               batch-size padding, averaged over dispatches;
  queue depth  sampled at every admission and dispatch — the backpressure
               signal admission control acts on.

Everything exports as one flat dict (``snapshot()``) so benchmark rows,
logs, and tests consume the same schema.

Memory is bounded for long-running services: latencies feed a fixed-size
:class:`repro_torch.obs.Reservoir` (exact percentiles below capacity — the pinned
small-sample tests see identical numbers — uniform subsample beyond it, with
count/mean always exact), and occupancy/queue-depth series keep only running
count/sum/max (:class:`repro_torch.obs.RunningStat`) since only their mean/max are
ever exported.  No per-sample list grows with traffic.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.obs.stats import Reservoir, RunningStat
from repro_torch.serve.su3.tenancy import class_key

FLOPS_PER_SITE = 864  # 4 links x 3x3x3 complex MACs x 8 real flops (paper §3.1)


LATENCY_RESERVOIR_CAPACITY = 4096  # exact percentiles below this many samples
CLASS_RESERVOIR_CAPACITY = 1024  # per-(tenant, class) latency reservoirs


def request_flops(n_sites: int, k: int) -> float:
    """Useful flops of one request: k chained multiplies over the lattice."""
    return float(FLOPS_PER_SITE) * n_sites * k


@dataclasses.dataclass
class ServiceMetrics:
    """Mutable counters; ``snapshot()`` is the exported read-only view."""

    started_s: float = dataclasses.field(default_factory=time.perf_counter)
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    dispatches: int = 0
    padded_slots: int = 0
    live_slots: int = 0
    busy_s: float = 0.0
    useful_flops: float = 0.0
    latencies_s: Reservoir = dataclasses.field(
        default_factory=lambda: Reservoir(LATENCY_RESERVOIR_CAPACITY))
    occupancies: RunningStat = dataclasses.field(default_factory=RunningStat)
    queue_depths: RunningStat = dataclasses.field(default_factory=RunningStat)
    compiles: int = 0  # cold (first-shape) dispatches, charged to busy_s too
    midchain_admits: int = 0  # continuous mode: requests seated into an
    # already-running chain (the admissions batch-per-step cannot make)
    host_dispatches: dict = dataclasses.field(default_factory=dict)  # host -> n
    iterations: int = 0  # continuous/megakernel scheduling turns (iteration
    # boundaries); dispatches/iterations is the dispatch-amortization figure
    # the megakernel path drives to 1.0 per host
    host_iterations: dict = dataclasses.field(default_factory=dict)  # host -> n
    kind_iterations: dict = dataclasses.field(default_factory=dict)  # kind -> n
    # per-kind iteration counts: "multiply"/"stencil" turns vs "solve" CG
    # iterations — the traffic mix's iteration bill by request family
    rejected_by_kind: dict = dataclasses.field(default_factory=dict)  # kind -> n
    # backpressure rejects split per request family (``rejected`` stays the
    # total, so the pre-existing snapshot key is unchanged)
    shed: int = 0  # queued requests evicted to admit higher-priority arrivals
    shed_by_kind: dict = dataclasses.field(default_factory=dict)
    timeouts: int = 0  # deadline evictions (queued or seated)
    timeouts_by_kind: dict = dataclasses.field(default_factory=dict)
    retries: int = 0  # re-dispatches consumed from the retry budget
    retries_exhausted: int = 0  # requests that gave up with a structured error
    faults_injected: int = 0  # chaos faults applied to this service's seams
    degraded_dispatches: int = 0  # megakernel batches re-run down the
    # per-(L) chained fallback path after a dispatch failure
    quarantines: int = 0  # hosts latched out by the health tracker
    reseated: int = 0  # requests moved off a quarantined host onto a healthy one
    # -- tenancy splits -------------------------------------------------------
    # per-(tenant, SLO class) views keyed "tenant/class"; the legacy totals
    # above are unchanged — the default tenant's traffic lands in
    # "default/bulk" / "default/latency" and sums to the old numbers
    admitted_by_class: dict = dataclasses.field(default_factory=dict)
    shed_by_class: dict = dataclasses.field(default_factory=dict)
    timeouts_by_class: dict = dataclasses.field(default_factory=dict)
    latencies_by_class: dict = dataclasses.field(default_factory=dict)
    # "tenant/class" -> Reservoir of completion latencies
    shed_for_kind: dict = dataclasses.field(default_factory=dict)
    # beneficiary attribution: which arriving kind (or "brownout") each shed
    # paid for — sums to ``shed``, so shed accounting reconciles with admits
    quota_rejected: int = 0  # submits refused by a tenant's token bucket
    quota_rejected_by_tenant: dict = dataclasses.field(default_factory=dict)
    preemptions: int = 0  # bulk seats evicted for a waiting latency request
    scale_ups: int = 0  # autoscaler grow events
    scale_downs: int = 0  # autoscaler shrink events
    active_hosts: int = 0  # current active pool size (gauge; 0 = unset)
    brownout_rung: int = 0  # current ladder rung (gauge)
    brownout_transitions: int = 0  # ladder moves (either direction)
    brownout_rung_turns: dict = dataclasses.field(default_factory=dict)
    # rung -> scheduling turns spent there (rung occupancy for the bench row)
    brownout_degraded_solve_turns: int = 0  # bulk solve turns run at reduced
    # iterations (and/or on a warm bf16 pool entry) by rung >= 2

    def reset(self) -> None:
        """Zero every counter and restart the wall clock (post-warmup)."""
        self.__init__()

    # -- recording -----------------------------------------------------------

    @staticmethod
    def _bump(d: dict, key: str, n: int = 1) -> None:
        d[key] = d.get(key, 0) + n

    def record_admit(self, queue_depth: int, tenant: str | None = None,
                     slo: str | None = None) -> None:
        self.admitted += 1
        self.queue_depths.add(queue_depth)
        if tenant is not None and slo is not None:
            self._bump(self.admitted_by_class, class_key(tenant, slo))

    def record_reject(self, kind: str = "multiply") -> None:
        self.rejected += 1
        self.rejected_by_kind[kind] = self.rejected_by_kind.get(kind, 0) + 1

    def record_quota_reject(self, tenant: str) -> None:
        self.quota_rejected += 1
        self._bump(self.quota_rejected_by_tenant, tenant)

    def record_shed(self, kind: str, for_kind: str = "",
                    tenant: str | None = None, slo: str | None = None) -> None:
        """One shed victim of ``kind``; ``for_kind`` is the BENEFICIARY —
        the arriving kind the victim paid for (or "brownout" for ladder
        sheds) — so ``shed_for_kind`` reconciles sheds against admits."""
        self.shed += 1
        self.shed_by_kind[kind] = self.shed_by_kind.get(kind, 0) + 1
        if for_kind:
            self._bump(self.shed_for_kind, for_kind)
        if tenant is not None and slo is not None:
            self._bump(self.shed_by_class, class_key(tenant, slo))

    def record_timeout(self, kind: str, tenant: str | None = None,
                       slo: str | None = None) -> None:
        self.timeouts += 1
        self.timeouts_by_kind[kind] = self.timeouts_by_kind.get(kind, 0) + 1
        if tenant is not None and slo is not None:
            self._bump(self.timeouts_by_class, class_key(tenant, slo))

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_scale(self, delta: int, active: int) -> None:
        if delta > 0:
            self.scale_ups += 1
        elif delta < 0:
            self.scale_downs += 1
        self.active_hosts = active

    def record_brownout_transition(self, rung: int) -> None:
        self.brownout_transitions += 1
        self.brownout_rung = rung

    def record_brownout_turn(self, rung: int) -> None:
        self._bump(self.brownout_rung_turns, str(rung))

    def record_degraded_solve_turn(self) -> None:
        self.brownout_degraded_solve_turns += 1

    def record_retry(self, n: int = 1) -> None:
        self.retries += n

    def record_retries_exhausted(self) -> None:
        self.retries_exhausted += 1

    def record_fault(self, n: int = 1) -> None:
        self.faults_injected += n

    def record_degraded(self) -> None:
        self.degraded_dispatches += 1

    def record_quarantine(self, reseated: int = 0) -> None:
        self.quarantines += 1
        self.reseated += reseated

    def record_dispatch(
        self, *, live: int, padded: int, step_s: float, flops: float,
        cold: bool = False, host: int = 0,
    ) -> None:
        """Account one device dispatch.

        ``live``/``padded`` are request slots (continuous mode charges each
        per-iteration dispatch at its chain's slot count, so occupancy is
        directly comparable with batch-per-step at the same warm size);
        ``host`` attributes the dispatch to a pool shard.
        """
        self.dispatches += 1
        self.live_slots += live
        self.padded_slots += padded - live
        self.busy_s += step_s
        self.useful_flops += flops
        self.occupancies.add(live / padded if padded else 0.0)
        self.host_dispatches[host] = self.host_dispatches.get(host, 0) + 1
        if cold:
            self.compiles += 1

    def record_midchain_admits(self, n: int = 1) -> None:
        self.midchain_admits += n

    def record_iteration(self, host: int = 0, kind: str = "multiply",
                         n: int = 1) -> None:
        """Account ``n`` iteration boundaries (continuous/megakernel
        scheduling turns, or solver CG iterations) of ``kind`` for ``host``
        — the denominator of dispatches-per-iteration, split per request
        family in ``kind_iterations``."""
        self.iterations += n
        self.host_iterations[host] = self.host_iterations.get(host, 0) + n
        self.kind_iterations[kind] = self.kind_iterations.get(kind, 0) + n

    def record_completion(self, latency_s: float, tenant: str | None = None,
                          slo: str | None = None) -> None:
        self.completed += 1
        self.latencies_s.add(latency_s)
        if tenant is not None and slo is not None:
            key = class_key(tenant, slo)
            res = self.latencies_by_class.get(key)
            if res is None:
                res = self.latencies_by_class[key] = Reservoir(
                    CLASS_RESERVOIR_CAPACITY)
            res.add(latency_s)

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depths.add(depth)

    # -- export --------------------------------------------------------------

    def _pct(self, q: float) -> float:
        return self.latencies_s.percentile(q)

    def snapshot(self) -> dict:
        wall = time.perf_counter() - self.started_s
        total_slots = self.live_slots + self.padded_slots
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "dispatches": self.dispatches,
            "compiles": self.compiles,
            "latency_p50_ms": round(self._pct(50) * 1e3, 3),
            "latency_p95_ms": round(self._pct(95) * 1e3, 3),
            "latency_p99_ms": round(self._pct(99) * 1e3, 3),
            "latency_mean_ms": round(self.latencies_s.mean() * 1e3, 3),
            "sustained_gflops_busy": round(
                self.useful_flops / self.busy_s / 1e9, 3
            ) if self.busy_s else 0.0,
            "sustained_gflops_wall": round(
                self.useful_flops / wall / 1e9, 3
            ) if wall else 0.0,
            "mean_batch_occupancy": round(self.occupancies.mean(), 3),
            "mean_live_batch": round(
                self.live_slots / self.dispatches, 3
            ) if self.dispatches else 0.0,
            "padded_slot_fraction": round(
                self.padded_slots / total_slots, 3
            ) if total_slots else 0.0,
            "midchain_admits": self.midchain_admits,
            "iterations": self.iterations,
            "dispatches_per_iteration": round(
                self.dispatches / self.iterations, 3
            ) if self.iterations else 0.0,
            "host_dispatches": {str(h): n for h, n in sorted(self.host_dispatches.items())},
            "kind_iterations": {k: n for k, n in sorted(self.kind_iterations.items())},
            "rejected_by_kind": {k: n for k, n in sorted(self.rejected_by_kind.items())},
            "shed": self.shed,
            "shed_by_kind": {k: n for k, n in sorted(self.shed_by_kind.items())},
            "timeouts": self.timeouts,
            "timeouts_by_kind": {k: n for k, n in sorted(self.timeouts_by_kind.items())},
            "retries": self.retries,
            "retries_exhausted": self.retries_exhausted,
            "faults_injected": self.faults_injected,
            "degraded_dispatches": self.degraded_dispatches,
            "quarantines": self.quarantines,
            "reseated": self.reseated,
            "queue_depth_max": int(self.queue_depths.max_or(0)),
            "queue_depth_mean": round(self.queue_depths.mean(), 3),
            "busy_s": round(self.busy_s, 4),
            "wall_s": round(wall, 4),
            # -- tenancy splits (additive keys; legacy keys above unchanged) --
            "admitted_by_class": {
                k: n for k, n in sorted(self.admitted_by_class.items())},
            "shed_by_class": {
                k: n for k, n in sorted(self.shed_by_class.items())},
            "shed_for_kind": {
                k: n for k, n in sorted(self.shed_for_kind.items())},
            "timeouts_by_class": {
                k: n for k, n in sorted(self.timeouts_by_class.items())},
            "latency_by_class_ms": {
                k: {
                    "p50": round(r.percentile(50) * 1e3, 3),
                    "p99": round(r.percentile(99) * 1e3, 3),
                    "count": r.count,
                }
                for k, r in sorted(self.latencies_by_class.items())
            },
            "quota_rejected": self.quota_rejected,
            "quota_rejected_by_tenant": {
                k: n for k, n in sorted(self.quota_rejected_by_tenant.items())},
            "preemptions": self.preemptions,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "active_hosts": self.active_hosts,
            "brownout_rung": self.brownout_rung,
            "brownout_transitions": self.brownout_transitions,
            "brownout_rung_turns": {
                k: n for k, n in sorted(self.brownout_rung_turns.items())},
            "brownout_degraded_solve_turns": self.brownout_degraded_solve_turns,
        }
