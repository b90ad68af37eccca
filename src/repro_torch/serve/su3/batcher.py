"""Dynamic request batching for SU3 lattice serving.

The serving analog of the paper's layout lesson: throughput is decided by
what you fix *before* the hot loop runs.  For traffic, that is the batch
shape — every distinct (lattice size, chain depth, batch size) triple is a
separate compiled dispatch, so an unmanaged request stream recompiles
constantly and runs batch-of-one.  The batcher makes the batch shape a
controlled, warm quantity:

  * **bucketing** — arriving requests are queued per ``(L, k)`` bucket
    (lattice size x chain depth); only shape-compatible requests coalesce
    into one batched dispatch.
  * **warm batch sizes** — a coalesced batch is padded up to the nearest
    size in ``warm_batch_sizes``, so the service warms a handful of
    batch shapes instead of one per observed batch size.  The
    padding cost is explicit: ``CoalescedBatch.occupancy`` is the live
    fraction, and the metrics charge padded slots as overhead.
  * **admission control** — ``submit`` rejects when the total queued depth
    would exceed ``max_queue_depth`` (backpressure to the caller), bounding
    queue-growth latency instead of letting p99 run away under overload.

The batcher is a plain steppable object — no threads, no event loop — so it
drops into a synchronous replay harness (benchmarks/serve_traffic.py), an
asyncio front-end (``SU3Service.arun``), or a test with the same semantics.

Two scheduling policies layered on top (both host-side bookkeeping only —
no torch in this module):

  * **locality routing** — :class:`LocalityRouter` pins each lattice size L
    to one host, sticky after first sight: the host that paid the compile +
    tile sweep for an L's warm runner keeps serving that L (the serving
    analog of the paper's first-touch rule — work follows the warm data).
  * **continuous batching** — :class:`InflightChain` tracks the slots of a
    chain that is being *re-dispatched one iteration at a time*: requests
    with the same L join at any iteration boundary (mid-chain admission)
    instead of waiting for the whole chain to drain; a request for another
    L can never join (the lattice shapes differ) and queues for its own
    chain.
  * **megakernel slot table** — :class:`SlotTable` is the per-host
    generalization the batched K-chain megakernel dispatches against: slots
    hold requests of ANY lattice size (the kernel pads every slot to one
    site capacity), each with its own remaining-iteration count, and one
    dispatch per host per iteration advances them all.  Mid-chain admission
    degenerates to a slot swap — seat the request, set its depth.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any

from repro_torch.serve.su3.tenancy import DEFAULT_TENANT, SLO_BULK, GroupKey

BucketKey = tuple[int, int]  # (L, chain depth k)


@dataclasses.dataclass
class ServeRequest:
    """One user's lattice request.

    ``kind="multiply"`` (default): C = A (x) B chained ``k`` times, with
    ``a`` the canonical lattice and ``b`` the (4, 3, 3) link matrix set.
    ``kind="stencil"``: one application of the nearest-neighbor Dslash-style
    operator, with ``a`` the canonical gauge lattice and ``b`` the canonical
    color-vector field (n_sites, 3); ``k`` is always 1 (the stencil is not
    chained — its output is a vector field, not a lattice).
    ``kind="solve"``: a staggered CG solve ``(sigma I + S) x = b`` with
    ``a`` the canonical gauge lattice and ``b`` the canonical right-hand
    side (n_sites, 3); ``tol``/``max_iters`` bound the solver and the
    request's iteration count is DATA-DEPENDENT — the service advances it a
    few CG iterations per scheduling turn and it retires mid-chain the turn
    its residual crosses tol.
    """

    req_id: int
    a: Any  # canonical complex (n_sites, 4, 3, 3)
    b: Any  # canonical complex (4, 3, 3) | (n_sites, 3) for stencil/solve
    L: int
    k: int
    arrival_s: float = 0.0  # perf_counter timestamp at admission
    kind: str = "multiply"  # "multiply" | "stencil" | "solve"
    seated_s: float = 0.0  # perf_counter timestamp when seated in a slot/batch
    # (0.0 until seated; the request-lifecycle span derives queue_wait from it)
    tol: float = 0.0  # solve: relative-residual convergence target
    max_iters: int = 0  # solve: iteration cap (retires unconverged at cap)
    deadline_s: float = 0.0  # absolute perf_counter deadline (0 = none); a
    # request past it is EVICTED (queue slot and live chain/table seat freed)
    # and completes with a structured DeadlineExceededError
    priority: int = 0  # shedding priority (robustness.PRIORITY[kind]): under
    # backpressure, lower priorities shed first to admit higher ones
    attempts: int = 0  # dispatch attempts consumed (retry accounting)
    tenant: str = DEFAULT_TENANT  # tenant identity (quota + fairness group)
    slo: str = SLO_BULK  # SLO class: "latency" (preempting, never shed) or
    # "bulk" (preemptible, the only sheddable lane); defaults bulk so a raw
    # request stays sheddable — the service sets the per-kind class default

    @property
    def n_sites(self) -> int:
        return self.L**4

    @property
    def bucket(self) -> BucketKey:
        return (self.L, self.k)

    @property
    def group(self) -> GroupKey:
        """The (tenant, SLO class) fairness group this request bills to."""
        return (self.tenant, self.slo)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 8  # hard cap on requests coalesced into one dispatch
    warm_batch_sizes: tuple[int, ...] = (1, 2, 4, 8)  # pad-to sizes (the warmed shapes)
    max_queue_depth: int = 64  # admission control: reject submits beyond this

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth} "
                f"(0 would reject every submit and livelock arun retries)"
            )
        if not self.warm_batch_sizes or sorted(self.warm_batch_sizes) != list(
            self.warm_batch_sizes
        ):
            raise ValueError(
                f"warm_batch_sizes must be ascending and non-empty, "
                f"got {self.warm_batch_sizes}"
            )
        if self.max_batch > self.warm_batch_sizes[-1]:
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the largest warm batch "
                f"size {self.warm_batch_sizes[-1]}: batches above it would "
                f"dispatch at never-warmed sizes, recompiling per observed "
                f"batch size"
            )

    def padded_size(self, n: int) -> int:
        """Nearest warm batch size >= n (n itself past the largest warm size)."""
        for w in self.warm_batch_sizes:
            if w >= n:
                return w
        return n


@dataclasses.dataclass
class CoalescedBatch:
    """Shape-compatible requests headed for one batched dispatch."""

    key: BucketKey
    requests: list[ServeRequest]
    padded_size: int

    @property
    def L(self) -> int:
        return self.key[0]

    @property
    def k(self) -> int:
        return self.key[1]

    @property
    def occupancy(self) -> float:
        """Live fraction of the dispatched batch (1.0 = no padding waste)."""
        return len(self.requests) / self.padded_size

    @property
    def pad(self) -> int:
        return self.padded_size - len(self.requests)


class DynamicBatcher:
    """Steppable coalescing queue with per-(L, k) buckets and backpressure."""

    def __init__(self, cfg: BatcherConfig | None = None):
        self.cfg = cfg if cfg is not None else BatcherConfig()
        # (group, bucket) -> FIFO of requests; OrderedDict keeps creation
        # order as the tiebreak when head-request arrival times are equal.
        # Keying the families by (tenant, SLO class) FIRST means a coalesced
        # dispatch only ever carries one group's requests — tenant isolation
        # extends into the batch, not just the queue.
        self._buckets: "OrderedDict[tuple[GroupKey, BucketKey], list[ServeRequest]]" \
            = OrderedDict()
        # stencil requests coalesce by L only (no chain depth); they never
        # ride multiply chains, so they live in their own queue family
        self._stencil: "OrderedDict[tuple[GroupKey, int], list[ServeRequest]]" \
            = OrderedDict()
        # solve requests also queue by L; the service advances ONE active
        # solve per host a few CG iterations per turn, so this family feeds
        # that seat oldest-first
        self._solve: "OrderedDict[tuple[GroupKey, int], list[ServeRequest]]" \
            = OrderedDict()
        self._depth = 0

    def __len__(self) -> int:
        return self._depth

    @property
    def depth(self) -> int:
        return self._depth

    def bucket_depths(self) -> dict[BucketKey, int]:
        """Waiting multiplies per (L, k), aggregated over tenant groups
        (the pre-tenancy key shape every caller and test pins)."""
        out: dict[BucketKey, int] = {}
        for (_g, key), q in self._buckets.items():
            if q:
                out[key] = out.get(key, 0) + len(q)
        return out

    def stencil_depths(self) -> dict[int, int]:
        """Waiting stencil requests per lattice size (all groups)."""
        out: dict[int, int] = {}
        for (_g, L), q in self._stencil.items():
            if q:
                out[L] = out.get(L, 0) + len(q)
        return out

    def solve_depths(self) -> dict[int, int]:
        """Waiting solve requests per lattice size (all groups)."""
        out: dict[int, int] = {}
        for (_g, L), q in self._solve.items():
            if q:
                out[L] = out.get(L, 0) + len(q)
        return out

    # -- tenancy views ---------------------------------------------------------

    def pending_kinds_by_group(self) -> dict[GroupKey, set[str]]:
        """Queued work per (tenant, SLO class) group: group -> kinds with at
        least one waiting request — the fair scheduler's pending set."""
        out: dict[GroupKey, set[str]] = {}
        for kind, (group, _key), q in self._family_items():
            if q:
                out.setdefault(group, set()).add(kind)
        return out

    def depth_for_slo(self, slo: str) -> int:
        """Total queued requests of one SLO class (any tenant, any kind) —
        the brownout ladder's reduced-bulk-budget check."""
        return sum(
            len(q) for _kind, (group, _key), q in self._family_items()
            if group[1] == slo
        )

    def has_waiting(self, kind: str, L: int | None = None,
                    slo: str | None = None) -> bool:
        """Any queued request of ``kind`` (optionally restricted to one
        lattice size and/or SLO class) — the preemption trigger check."""
        for fam_kind, (group, key), q in self._family_items():
            if fam_kind != kind or not q:
                continue
            if slo is not None and group[1] != slo:
                continue
            fam_L = key[0] if fam_kind == "multiply" else key
            if L is not None and fam_L != L:
                continue
            return True
        return False

    def submit(self, req: ServeRequest) -> bool:
        """Admit a request; False under backpressure (queue budget exhausted).
        Multiply requests bucket by (group, (L, k)); stencil and solve
        requests by (group, L) — all families draw on one depth budget."""
        if self._depth >= self.cfg.max_queue_depth:
            return False
        if not req.arrival_s:
            req.arrival_s = time.perf_counter()
        if req.kind == "stencil":
            self._stencil.setdefault((req.group, req.L), []).append(req)
        elif req.kind == "solve":
            self._solve.setdefault((req.group, req.L), []).append(req)
        else:
            self._buckets.setdefault((req.group, req.bucket), []).append(req)
        self._depth += 1
        return True

    def next_solve(self, group: GroupKey | None = None) -> ServeRequest | None:
        """Pop the oldest waiting solve request (across lattice sizes) —
        the service seats it as the host's active solve.  Solves never
        coalesce: each carries its own data-dependent iteration count.
        ``group`` restricts the pop to one (tenant, class) — the fair
        scheduler serves exactly the group that owns the turn."""
        live = [
            (key, q) for (g, key), q in self._solve.items()
            if q and (group is None or g == group)
        ]
        if not live:
            return None
        _L, queue = min(live, key=lambda kv: kv[1][0].arrival_s)
        req = queue.pop(0)
        self._depth -= 1
        return req

    def next_stencil_batch(self, group: GroupKey | None = None) -> CoalescedBatch | None:
        """Coalesce up to ``max_batch`` stencil requests of the most urgent
        lattice size (oldest waiting head first), warm-size padded like the
        multiply buckets.  The batch ``key`` is ``(L, 1)`` — one stencil
        application per request.  ``group`` restricts to one (tenant, class);
        batches never mix groups either way (the families are group-keyed)."""
        live = [
            (key, q) for (g, key), q in self._stencil.items()
            if q and (group is None or g == group)
        ]
        if not live:
            return None
        L, queue = min(live, key=lambda kv: kv[1][0].arrival_s)
        take = queue[: self.cfg.max_batch]
        queue[:] = queue[len(take):]
        self._depth -= len(take)
        return CoalescedBatch(
            key=(L, 1), requests=take, padded_size=self.cfg.padded_size(len(take))
        )

    def next_batch(self, group: GroupKey | None = None) -> CoalescedBatch | None:
        """Coalesce up to ``max_batch`` requests from the most urgent bucket.

        Urgency is head-of-line arrival time (oldest waiting request first),
        so no bucket starves under mixed traffic: a lone L=2 request queued
        behind a stream of L=4 batches is picked as soon as it is oldest.
        ``group`` restricts to one (tenant, class); a batch never mixes
        groups either way — the buckets themselves are group-keyed.
        """
        live = [
            (key, q) for (g, key), q in self._buckets.items()
            if q and (group is None or g == group)
        ]
        if not live:
            return None
        key, queue = min(live, key=lambda kv: kv[1][0].arrival_s)
        take = queue[: self.cfg.max_batch]
        queue[:] = queue[len(take):]
        self._depth -= len(take)
        return CoalescedBatch(
            key=key, requests=take, padded_size=self.cfg.padded_size(len(take))
        )

    # -- robustness views ------------------------------------------------------

    def _family_items(self):
        """Every queue as a (kind, (group, key), queue) triple."""
        for gkey, q in self._buckets.items():
            yield "multiply", gkey, q
        for gkey, q in self._stencil.items():
            yield "stencil", gkey, q
        for gkey, q in self._solve.items():
            yield "solve", gkey, q

    def _families(self):
        """The three queue families as (kind, key, queue) triples (legacy
        key shape: (L, k) for multiplies, L otherwise)."""
        for kind, (_group, key), q in self._family_items():
            yield kind, key, q

    def evict_expired(self, now: float) -> list[ServeRequest]:
        """Pop every queued request whose deadline passed; the caller turns
        them into structured timeouts.  Requests without a deadline
        (``deadline_s == 0``) never expire."""
        evicted: list[ServeRequest] = []
        for _kind, _key, q in self._families():
            keep = []
            for req in q:
                if req.deadline_s and req.deadline_s <= now:
                    evicted.append(req)
                else:
                    keep.append(req)
            q[:] = keep
        self._depth -= len(evicted)
        return evicted

    def shed_lowest(self, max_priority: int,
                    sheddable_slo: str | None = None) -> ServeRequest | None:
        """Pop the YOUNGEST queued request with priority < ``max_priority``
        (the freshest bulk work pays for the latency-sensitive arrival —
        oldest bulk requests have waited longest and keep their place).
        ``sheddable_slo`` additionally restricts victims to one SLO class
        (the service passes "bulk": the latency lane is never shed).
        Returns None when nothing sheddable waits."""
        best: tuple[float, Any, list] | None = None
        for _kind, key, q in self._families():
            for req in q:
                if sheddable_slo is not None and req.slo != sheddable_slo:
                    continue
                if req.priority < max_priority and (
                    best is None or req.arrival_s > best[0]
                ):
                    best = (req.arrival_s, req, q)
        if best is None:
            return None
        _arrival, req, q = best
        q.remove(req)
        self._depth -= 1
        return req

    def drain(self) -> list[ServeRequest]:
        """Pop EVERY queued request (quarantine re-seating: the caller
        resubmits them through the router onto healthy hosts)."""
        out: list[ServeRequest] = []
        for _kind, _key, q in self._families():
            out.extend(q)
            q.clear()
        self._depth = 0
        return out

    # -- continuous-batching admission views ----------------------------------

    def queued_Ls(self, group: GroupKey | None = None) -> list[int]:
        """Distinct lattice sizes with waiting requests, oldest-head first
        (optionally restricted to one (tenant, class) group)."""
        heads: dict[int, float] = {}
        for (g, (L, _k)), q in self._buckets.items():
            if q and (group is None or g == group):
                heads[L] = min(heads.get(L, q[0].arrival_s), q[0].arrival_s)
        return sorted(heads, key=heads.__getitem__)

    def next_for_L(self, L: int, max_n: int,
                   group: GroupKey | None = None) -> list[ServeRequest]:
        """Pop up to ``max_n`` oldest waiting requests of lattice size ``L``,
        across every chain depth k.

        Continuous batching admits by *shape* compatibility only — a chain
        in flight for L can absorb requests of any k (each slot tracks its
        own remaining iterations), so the (L, k) buckets merge here by
        arrival order.  ``group`` restricts the pops to one (tenant, class)
        — a fair turn admits only the turn owner's requests, though seated
        slots of every group still advance together (the chain's dispatch
        is shared).  Returns ``[]`` when nothing eligible of size L waits.
        """
        if max_n < 1:
            return []
        out: list[ServeRequest] = []
        while len(out) < max_n:
            candidates = [
                (gkey, q) for gkey, q in self._buckets.items()
                if q and gkey[1][0] == L
                and (group is None or gkey[0] == group)
            ]
            if not candidates:
                break
            _gkey, queue = min(candidates, key=lambda kv: kv[1][0].arrival_s)
            out.append(queue.pop(0))
            self._depth -= 1
        return out


class LocalityRouter:
    """Sticky (lattice size -> host) routing for a host-sharded warm pool.

    The first request for a lattice size L is assigned to the least-loaded
    host (by cumulative admitted flops); every later L request follows it.
    That host's pool holds L's warm ``BatchedLatticeRunner`` — the compile
    and tile/K sweeps were paid there, its devices hold the warm dispatch
    shapes — so routing by locality means never re-warming an L on a second
    host while the first sits idle (the serving analog of the paper's
    "work runs where the data was first touched").

    Host-side bookkeeping only; safe under any request mix.
    """

    def __init__(self, n_hosts: int):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = n_hosts
        self._home: dict[int, int] = {}  # L -> host
        self._load: list[float] = [0.0] * n_hosts  # cumulative admitted flops

    def host_for(self, L: int) -> int:
        """The home host for lattice size L (assigned on first sight).

        Assignment charges the chosen host a nominal placement load (one
        multiply's flops, 864·L⁴) immediately — otherwise a burst of
        first-sight Ls with no traffic in between (``SU3Service.warm``
        pre-building several sizes) would all see every host at zero load
        and pile onto host 0, pinning the whole pool there forever.
        """
        if L not in self._home:
            host = min(range(self.n_hosts), key=self._load.__getitem__)
            self._home[L] = host
            self._load[host] += 864.0 * L**4  # nominal placement charge
        return self._home[L]

    def peek(self, L: int) -> int | None:
        """L's home host, or None if L has never been routed."""
        return self._home.get(L)

    def record_load(self, host: int, flops: float) -> None:
        """Charge admitted work to ``host`` (steers future first-sight Ls)."""
        self._load[host] += flops

    def assignments(self) -> dict[int, int]:
        """Snapshot of the sticky (L -> host) table."""
        return dict(self._home)

    def loads(self) -> list[float]:
        return list(self._load)


@dataclasses.dataclass
class InflightChain:
    """Slot bookkeeping of one continuously-batched chain (one L, one host).

    The chain's lattice batch is dispatched ONE iteration at a time; between
    iterations (`advance`) this object decides who occupies the slots:

      * ``admit`` places a same-L request into a free slot with its own
        remaining-iteration count — mid-chain admission at an iteration
        boundary, the continuous-batching move;
      * a request for a different L is *rejected* (``can_admit`` False):
        its lattice shape is incompatible with the in-flight batch and it
        must queue for its own chain;
      * ``advance`` decrements every live slot and frees the finished ones.

    Array state (the physical lattice batch) lives with the service; this is
    the scheduling half, testable without a device.
    """

    L: int
    slots: int
    iterations_run: int = 0
    _req: list[ServeRequest | None] = dataclasses.field(default_factory=list)
    _remaining: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.slots < 1:
            raise ValueError(f"chain needs >= 1 slot, got {self.slots}")
        self._req = [None] * self.slots
        self._remaining = [0] * self.slots

    # -- occupancy -------------------------------------------------------------

    @property
    def live(self) -> int:
        """Slots currently carrying a request."""
        return sum(1 for r in self._req if r is not None)

    @property
    def occupancy(self) -> float:
        return self.live / self.slots

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._req) if r is None]

    def requests(self) -> list[ServeRequest]:
        return [r for r in self._req if r is not None]

    def occupants(self) -> list[tuple[int, ServeRequest, int]]:
        """Live ``(slot, request, remaining)`` triples (eviction scans)."""
        return [
            (i, r, self._remaining[i])
            for i, r in enumerate(self._req)
            if r is not None
        ]

    # -- admission -------------------------------------------------------------

    def can_admit(self, req: ServeRequest) -> bool:
        """Shape-compatible (same L) and a slot is free."""
        return req.L == self.L and self.live < self.slots

    def admit(self, req: ServeRequest) -> int:
        """Seat ``req`` in a free slot; returns the slot index.

        Raises ValueError on an incompatible lattice size — the caller must
        check :meth:`can_admit` (or catch) and queue the request for its own
        chain instead.
        """
        if req.L != self.L:
            raise ValueError(
                f"request L={req.L} cannot join an in-flight L={self.L} chain "
                f"(incompatible lattice shape); it must wait for its own chain"
            )
        for i, r in enumerate(self._req):
            if r is None:
                self._req[i] = req
                self._remaining[i] = req.k
                return i
        raise ValueError(f"chain L={self.L} is full ({self.slots} slots)")

    @property
    def midchain(self) -> bool:
        """True once the chain has advanced at least one iteration — a later
        admit is a mid-chain admit (the case batch-per-step cannot serve)."""
        return self.iterations_run > 0

    def evict(self, slot: int) -> ServeRequest:
        """Free a LIVE slot mid-chain (deadline eviction / quarantine
        re-seating) and return its request; the freed slot is immediately
        admissible — the same re-seating machinery mid-chain admission
        uses.  A fully-drained chain resets to fresh, exactly as a drain
        through :meth:`advance` does."""
        req = self._req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not live")
        self._req[slot] = None
        self._remaining[slot] = 0
        if self.live == 0:
            self.iterations_run = 0
        return req

    # -- advancement -----------------------------------------------------------

    def advance(self) -> list[tuple[int, ServeRequest]]:
        """Account one executed iteration; returns [(slot, request)] finished.

        Call AFTER the iteration's dispatch: every live slot consumed one
        multiply; slots reaching zero remaining iterations complete and
        free.  A chain that fully drains resets to fresh (``midchain``
        False): an admit into a retained-but-empty chain is exactly a new
        batch start, not a mid-chain join, and must not be counted as one.
        """
        done: list[tuple[int, ServeRequest]] = []
        for i, r in enumerate(self._req):
            if r is None:
                continue
            self._remaining[i] -= 1
            if self._remaining[i] <= 0:
                done.append((i, r))
                self._req[i] = None
                self._remaining[i] = 0
        self.iterations_run = 0 if self.live == 0 else self.iterations_run + 1
        return done


@dataclasses.dataclass
class SlotTable:
    """Slot bookkeeping of one host's megakernel dispatch table.

    The megakernel generalization of :class:`InflightChain`: ONE table per
    host, slots hold in-flight requests of ANY lattice size (the batched
    K-chain kernel pads every slot to a common site capacity), and one
    dispatch per host per iteration advances every live slot by its own
    scheduled depth.  What was "mid-chain admission" in the per-L chain
    becomes a *slot swap*: seat the request in a free slot, set its
    remaining count — no shape compatibility gate, because the dispatched
    shape is the table's, not the request's.

    Array state (the physical slot-table batch) lives with the service; this
    is the scheduling half, testable without a device.
    """

    slots: int
    iterations_run: int = 0
    _req: list[ServeRequest | None] = dataclasses.field(default_factory=list)
    _remaining: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.slots < 1:
            raise ValueError(f"slot table needs >= 1 slot, got {self.slots}")
        self._req = [None] * self.slots
        self._remaining = [0] * self.slots

    # -- occupancy -------------------------------------------------------------

    @property
    def live(self) -> int:
        return sum(1 for r in self._req if r is not None)

    @property
    def occupancy(self) -> float:
        return self.live / self.slots

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._req) if r is None]

    def requests(self) -> list[ServeRequest]:
        return [r for r in self._req if r is not None]

    def occupants(self) -> list[tuple[int, ServeRequest, int]]:
        """Live ``(slot, request, remaining)`` triples — what a capacity-grow
        re-seats into the replacement table."""
        return [
            (i, r, self._remaining[i])
            for i, r in enumerate(self._req)
            if r is not None
        ]

    @property
    def max_live_L(self) -> int:
        """Largest lattice size seated (0 when empty) — the capacity floor."""
        return max((r.L for r in self._req if r is not None), default=0)

    # -- admission (slot swap) -------------------------------------------------

    def can_admit(self) -> bool:
        return self.live < self.slots

    def admit(self, req: ServeRequest, remaining: int | None = None) -> int:
        """Seat ``req`` in a free slot; returns the slot index.

        Any lattice size is admissible — the megakernel pads every slot to
        the table's site capacity, so there is no shape gate to fail (the
        *capacity* gate lives with the service, which grows the physical
        table when a larger L arrives).
        """
        for i, r in enumerate(self._req):
            if r is None:
                self._req[i] = req
                self._remaining[i] = req.k if remaining is None else remaining
                return i
        raise ValueError(f"slot table is full ({self.slots} slots)")

    @property
    def midchain(self) -> bool:
        """True once the table has advanced at least one iteration with live
        slots — a later admit is a mid-chain slot swap."""
        return self.iterations_run > 0

    def evict(self, slot: int) -> ServeRequest:
        """Free a LIVE slot mid-chain (deadline eviction / quarantine
        re-seating) and return its request — the inverse slot swap of
        :meth:`admit`, leaving the slot immediately admissible.  A table
        drained by evictions resets to fresh like one drained by
        :meth:`advance`."""
        req = self._req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not live")
        self._req[slot] = None
        self._remaining[slot] = 0
        if self.live == 0:
            self.iterations_run = 0
        return req

    def slot_of(self, req_id: int) -> int | None:
        """The slot seating ``req_id`` (None when not seated)."""
        for i, r in enumerate(self._req):
            if r is not None and r.req_id == req_id:
                return i
        return None

    # -- advancement -----------------------------------------------------------

    def plan_k(self, horizon: int = 1) -> list[int]:
        """Per-slot chain depths for the NEXT megakernel dispatch.

        Each live slot advances ``min(remaining, horizon)`` multiplies; dead
        slots get 0 (the kernel passes them through).  ``horizon`` trades
        admission latency for dispatch amortization: 1 re-opens admission at
        every multiply, larger values chain deeper in-kernel between
        boundaries.
        """
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        return [
            min(self._remaining[i], horizon) if self._req[i] is not None else 0
            for i in range(self.slots)
        ]

    def advance(self, applied: list[int]) -> list[tuple[int, ServeRequest]]:
        """Account one executed dispatch that ran ``applied[i]`` multiplies on
        slot ``i``; returns [(slot, request)] finished.

        Call AFTER the dispatch with the ``plan_k`` schedule that was run.
        A table that fully drains resets to fresh (``midchain`` False).
        """
        if len(applied) != self.slots:
            raise ValueError(f"applied must cover all {self.slots} slots")
        done: list[tuple[int, ServeRequest]] = []
        for i, r in enumerate(self._req):
            if r is None:
                continue
            self._remaining[i] -= applied[i]
            if self._remaining[i] <= 0:
                done.append((i, r))
                self._req[i] = None
                self._remaining[i] = 0
        self.iterations_run = 0 if self.live == 0 else self.iterations_run + 1
        return done
