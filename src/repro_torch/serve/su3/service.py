"""SU3Service: the plan layer behind a traffic-handling front door (port of
``repro.serve.su3.service`` to PyTorch and CUDA: one controller, each
host's runners on its own card where the process has one).

Composition (everything below the service already exists in the plan layer;
the service adds the queueing discipline and the warm-pool policy):

    submit(a, b, k)                      arun(a, b, k)  [asyncio face]
          │ LocalityRouter — sticky L -> host (work follows the warm data)
          ▼
    per-host DynamicBatcher — (L, k) buckets, warm-size padding, admission
          │  next_batch()  one CoalescedBatch per step()        [batch mode]
          │  next_for_L()  iteration-boundary admission     [continuous mode]
          ▼
    per-host warm pool:
          {(host, L, dtype, layout, tile) -> BatchedLatticeRunner}
          │  host h's runners plan on its block of the service's devices
          │  (``MeshSpec.host_submesh(h)``: its own cards when the process
          │  sees at least ``hosts`` of them, the head of the list, as the
          │  reference oversubscribes a short pool, when it does not), and
          │  are built through the persistent autotune cache: the FIRST
          │  request for an (L, dtype) pays the tile/K sweep, every later
          │  request hits the warm plan
          ▼
    one batched kernel launch per device of the host's block, whole
    lattices each (optionally bf16-storage/f32-accumulate)
          │
          ▼
    split + unpad per request  ->  results keyed by request id

The chain depth ``k`` defaults to the autotuned fused depth for the request's
(backend, L) — ``autotune.tuned_fused_k`` — so callers that don't care get
the measured-best dispatch amortization instead of a hardcoded constant.

Stencil requests (``submit_stencil``) ride the same front door: same
locality router, same per-host batcher (their own by-L queue family), same
warm runner pool.  They coalesce into one stencil dispatch per scheduling
turn — one gather and one stencil kernel launch per lattice of the batch
(the stencil kernel has no batch axis) — and return canonical vector
fields; they never join multiply chains in any dispatch mode.

Solve requests (``submit_solve``) are the flagship iterative workload: a
staggered CG solve ``(sigma I + S) x = b`` through the plan's fused
stencil+axpy iteration (``ExecutionPlan.cg_state_init`` / ``cg_iterate``).
Each host runs ONE active solve at a time, advanced
``solve_iters_per_step`` CG iterations per scheduling turn — its iteration
count is data-dependent, so it retires *mid-chain* the turn its residual
crosses tol (or at ``max_iters``), freeing its seat and queue budget while
multiply chains are still in flight.  When a host has several kinds
pending, turns rotate multiply → stencil → solve so no sustained stream of
one kind starves the others.

Dispatch modes
--------------
``batch-per-step`` (default): one ``step()`` call dispatches one coalesced
(L, k) bucket through one fused-k launch over the whole batch.  Requests arriving while a
chain runs wait for the next ``step()``.

``continuous`` (``ServiceConfig(continuous=True)``): each (host, L) keeps an
:class:`~repro_torch.serve.su3.batcher.InflightChain` whose lattice batch is
re-dispatched ONE iteration at a time; at every iteration boundary, waiting
same-L requests are admitted into free slots (mid-chain admission — each
slot carries its own remaining-iteration count, so mixed k coexists in one
chain).  A request for a different L is shape-incompatible with the
in-flight batch and queues for its own chain.  Under open-loop load this
keeps the dispatched slots fuller than batch-per-step — measured by
``benchmarks/serve_traffic.py``'s continuous-vs-batch row.

``megakernel`` (``ServiceConfig(continuous=True, megakernel=True)``): the
continuous path's dispatch bill — one kernel launch per (host, L) chain per
iteration, the pipeline-throughput tax the paper measures on PIUMA — is
collapsed to ONE launch of the batched K-chain CUDA kernel
(``su3_mult_planar_batched``) per host per iteration.  Each host keeps a
single mixed-L :class:`SlotTable`; every slot is padded to the table's site
capacity (grown, with live slots re-seated, when a larger L arrives),
per-slot chain depths travel as an int32 tensor the kernel reads on the
card (copied from pinned memory without a host sync), and mid-chain
admission becomes a slot swap.  ``chain_horizon`` chains that many
multiplies in-kernel between admission boundaries.

The slot table is written in place by the kernel unless a fault plan or the
numerics guard is armed: those roll the table back after a poisoned or
non-finite dispatch, so they keep the old table and the kernel writes a new
one.  A delivered result is always a new tensor, never a view of a table.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import random
import time
from typing import Any

import torch

from repro_torch.chaos.faults import NULL_FAULT_PLAN, FaultPlan, poison_array
from repro_torch.core import autotune
from repro_torch.core.su3.layouts import Layout
from repro_torch.core.su3.plan import (
    CG_DIVERGENCE_FACTOR,
    BatchedLatticeRunner,
    CGDivergedError,
    EngineConfig,
)
from repro_torch.distributed.sharding import BatchBlock, device_parts
from repro_torch.kernels.su3_stencil import (
    CG_ITER_FLOPS_PER_SITE,
    STENCIL_FLOPS_PER_SITE,
)
from repro_torch.launch.mesh import MeshSpec
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.serve.su3.batcher import (
    BatcherConfig,
    DynamicBatcher,
    InflightChain,
    LocalityRouter,
    ServeRequest,
    SlotTable,
)
from repro_torch.serve.su3.metrics import ServiceMetrics, request_flops
from repro_torch.serve.su3.robustness import (
    PRIORITY,
    DeadlineExceededError,
    HostHealth,
    LoadShedError,
    RequestFailure,
    RetriesExhaustedError,
    RetryPolicy,
)
from repro_torch.serve.su3.tenancy import (
    DEFAULT_KIND_SLO,
    DEFAULT_TENANT,
    SLO_BULK,
    SLO_CLASSES,
    SLO_LATENCY,
    AutoscaleConfig,
    BrownoutConfig,
    BrownoutLadder,
    DeficitFairScheduler,
    GroupKey,
    SLOPolicy,
    TenantQuota,
    TokenBucket,
    WarmPoolAutoscaler,
)

DEFAULT_TILE = 128  # small enough that every L >= 2 bucket is a few tiles


def _parts(x: torch.Tensor | list[torch.Tensor]) -> list[torch.Tensor]:
    """A batch's tensors: one, or one per device it lies on."""
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _sync(x: torch.Tensor | list[torch.Tensor]) -> None:
    """Wait for the work that produced ``x`` (a no-op on the CPU)."""
    for t in _parts(x):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

# Chrome-trace lane assignment: dispatch spans ride the host's lane so one
# timeline row per host shows the dispatch cadence; request-lifecycle spans
# spread over a block of per-request lanes so overlapping requests don't
# fake nesting in the viewer.
_REQUEST_LANE_BASE = 100
_REQUEST_LANES = 32


def _request_lane(req_id: int) -> int:
    return _REQUEST_LANE_BASE + req_id % _REQUEST_LANES


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """The serving tuple: storage/compute dtypes, layout, tuning, batching,
    host topology, and dispatch mode.

    Attributes:
        dtype: storage dtype of every plan in the pool.
        accum_dtype: ``"float32"`` with ``dtype="bfloat16"`` = bf16-storage /
            f32-accumulate serving plans.
        compression: ``"two_row"`` serves 12-real compressed-gauge plans
            (row 2 reconstructed in-register by every kernel in the pool);
            stacks with the bf16/f32 mixed-precision tuple.
        layout: physical lattice layout (planar-view layouts only).
        autotune: build runner configs through the persistent cache
            (:mod:`repro_torch.core.autotune`; measured on the service's
            device).
        tile: explicit tile when ``autotune=False`` (0 = DEFAULT_TILE); the
            site padding unit (the CUDA kernels' block size is fixed).
        default_k: chain depth when a request leaves k unset; 0 = autotuned.
        batcher: per-host queue discipline (each host gets its own
            DynamicBatcher with this config — admission control is per host).
        cache_directory: autotune cache override (tests).
        hosts: split the warm pool over this many LOGICAL hosts; requests
            route to an L's home host (sticky locality routing) and each
            host has its own batcher, chains and slot table.  Host ``h``
            runs on ``MeshSpec(hosts).host_devices(h)`` of the service's
            device pool, whole lattices per device: its own cards when the
            pool holds at least ``hosts`` devices; on fewer (one card, or
            the CPU) every host shares the head of the pool — the
            reference's oversubscription of a short pool: the
            routing/batching semantics are identical, only physical
            placement collapses.
        continuous: continuous-batching dispatch (iteration-boundary
            admission into in-flight chains) instead of batch-per-step.
        chain_slots: slots per in-flight chain (continuous mode);
            0 = the batcher's ``padded_size(max_batch)``.
        megakernel: continuous mode dispatches ONE batched K-chain
            megakernel launch per host per iteration over a single mixed-L
            slot table (``ExecutionPlan.fused_batched_step``) instead of one
            k=1 launch per (host, L) chain — the dispatch-amortized path
            (requires ``continuous=True``).
        chain_horizon: megakernel in-kernel chain depth per slot between
            admission boundaries; 1 re-opens admission at every multiply,
            larger values amortize more dispatches per request at the cost
            of admission latency.
        solve_iters_per_step: CG iterations the host's active solve advances
            per scheduling turn; small values re-open kind rotation (and
            thus multiply/stencil service) more often, large values amortize
            more solver work per turn at the cost of mix latency.
        faults: optional :class:`repro_torch.chaos.FaultPlan` armed over
            the service's injection seams (dispatch / kernel / pool).  None = the shared disabled plan —
            every seam is one ``if faults.enabled`` branch, zero cost.
        retry: capped-exponential-backoff retry policy plus the service-wide
            retry budget for failed dispatches.
        default_deadline_s: relative deadline applied to every request that
            does not pass its own (0 = none); a request past its deadline is
            evicted — from the queue OR its live chain/table seat — and
            completes with a structured ``DeadlineExceededError``.
        quarantine_after: consecutive dispatch failures that latch a host
            out of service (its requests re-seat onto healthy hosts);
            single-host services never self-quarantine.
        numerics_guard: check dispatch outputs for NaN/Inf even with no
            fault plan armed (chaos runs always check).
        slo: per-class policy — deadline defaults and fair-scheduler weights
            for the ``latency`` and ``bulk`` lanes.
        quotas: optional per-tenant :class:`TenantQuota` token buckets
            (``{tenant: TenantQuota}``); a tenant past its bucket is
            rejected at the front door (``submit_*`` returns None, counted
            in ``quota_rejected``).  Tenants absent from the map are
            unmetered.
        autoscale: warm-pool controller; when enabled the service starts at
            ``min_hosts`` active hosts and grows/shrinks the active set
            from queue-depth/occupancy pressure with hysteresis (shrink
            never evicts a seated latency request).  Disabled = every
            configured host stays active (pre-tenancy behavior).
        brownout: optional three-rung overload ladder over the bulk lane
            (None = disabled): rung 1 sheds bulk admissions past a reduced
            queue share, rung 2 additionally degrades bulk solves, rung 3
            rejects new bulk with a Retry-After hint in the LoadShedError.
    """

    dtype: str = "float32"  # storage dtype of every plan in the pool
    accum_dtype: str = ""  # "float32" + dtype="bfloat16" = bf16 serving plans
    compression: str = "none"  # "two_row" = 12-real compressed-gauge plans
    layout: Layout = Layout.SOA
    autotune: bool = True  # build runner configs through the persistent cache
    tile: int = 0  # explicit tile when autotune=False (0 = DEFAULT_TILE)
    default_k: int = 0  # chain depth when a request leaves k unset; 0 = tuned
    batcher: BatcherConfig = dataclasses.field(default_factory=BatcherConfig)
    cache_directory: str | None = None  # autotune cache override (tests)
    hosts: int = 1  # shard the warm pool across this many hosts
    continuous: bool = False  # iteration-boundary admission dispatch
    chain_slots: int = 0  # continuous-chain slots; 0 = padded max_batch
    megakernel: bool = False  # one batched dispatch/host/iteration (continuous)
    chain_horizon: int = 1  # megakernel in-kernel chain depth between boundaries
    solve_iters_per_step: int = 4  # CG iterations per solve scheduling turn
    faults: FaultPlan | None = None  # chaos plan armed over the serve seams
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    default_deadline_s: float = 0.0  # relative per-request deadline (0 = none)
    quarantine_after: int = 3  # consecutive failures latching a host out
    numerics_guard: bool = False  # NaN/Inf-check outputs without a fault plan
    slo: SLOPolicy = dataclasses.field(default_factory=SLOPolicy)
    quotas: Any = None  # {tenant: TenantQuota} token buckets (None = unmetered)
    autoscale: AutoscaleConfig = dataclasses.field(default_factory=AutoscaleConfig)
    brownout: BrownoutConfig | None = None  # overload ladder (None = disabled)

    def __post_init__(self) -> None:
        # the pool serves the planar CUDA kernels; AOS has no planar view,
        # so reject it here instead of inside the first user request
        if Layout(self.layout) not in (Layout.SOA, Layout.AOSOA):
            raise ValueError(
                f"serving pool requires a planar-view layout (soa/aosoa), "
                f"got {Layout(self.layout).value!r}"
            )
        # best_config sweeps (and cache-keys) SoA plans only — applying its
        # tile/fused_k to another layout would serve never-measured numbers
        # under a mislabeled cache entry
        if self.autotune and Layout(self.layout) != Layout.SOA:
            raise ValueError(
                "the autotune cache tunes SoA plans only; serve "
                f"{Layout(self.layout).value!r} with autotune=False and an "
                "explicit tile"
            )
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.chain_slots < 0:
            raise ValueError(f"chain_slots must be >= 0, got {self.chain_slots}")
        if self.megakernel and not self.continuous:
            raise ValueError(
                "megakernel dispatch is the continuous path's amortizer; "
                "set continuous=True (batch-per-step already fuses its k "
                "chain in one dispatch)"
            )
        if self.chain_horizon < 1:
            raise ValueError(f"chain_horizon must be >= 1, got {self.chain_horizon}")
        if self.solve_iters_per_step < 1:
            raise ValueError(
                f"solve_iters_per_step must be >= 1, got "
                f"{self.solve_iters_per_step}"
            )
        if self.default_deadline_s < 0:
            raise ValueError(
                f"default_deadline_s must be >= 0, got {self.default_deadline_s}"
            )
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {self.quarantine_after}"
            )
        if self.quotas is not None:
            for tenant, quota in dict(self.quotas).items():
                if not tenant or not isinstance(tenant, str):
                    raise ValueError(
                        f"quota tenants must be non-empty strings, got "
                        f"{tenant!r}"
                    )
                if not isinstance(quota, TenantQuota):
                    raise ValueError(
                        f"quotas values must be TenantQuota, got "
                        f"{type(quota).__name__} for tenant {tenant!r}"
                    )
        if self.autoscale.enabled and self.autoscale.min_hosts > self.hosts:
            raise ValueError(
                f"autoscale.min_hosts={self.autoscale.min_hosts} exceeds "
                f"hosts={self.hosts}"
            )


class _TableArrays:
    """Device-array half of a table of ``slots`` lattice slots, split into
    the runner's batch blocks: one tensor per device run of blocks
    (``a_parts`` physical lattices, ``b_parts`` planar B's).  Seating a
    request writes its slot on the device that owns it; free slots carry
    zero lattices."""

    def __init__(self, runner: BatchedLatticeRunner, blocks: list[BatchBlock]):
        self.runner = runner
        plan = runner.plan
        self.parts = device_parts(blocks)
        shape = plan.codec.phys_shape(plan.padded_sites)
        self.a_parts = [torch.zeros((p[-1].hi - p[0].lo,) + shape, dtype=plan.codec.word_dtype,
                                    device=p[0].device) for p in self.parts]
        self.b_parts = [torch.zeros((p[-1].hi - p[0].lo, 2, 36), dtype=plan.codec.word_dtype,
                                    device=p[0].device) for p in self.parts]

    @property
    def a_phys(self) -> torch.Tensor:
        """The physical table as one tensor (its blocks share a device).

        Raises:
            ValueError: the table lies on several devices (read ``a_parts``).
        """
        if len(self.a_parts) != 1:
            raise ValueError(f"the table lies on {len(self.a_parts)} devices: read a_parts")
        return self.a_parts[0]

    def _locate(self, slot: int) -> tuple[int, int]:
        for j, p in enumerate(self.parts):
            if p[0].lo <= slot < p[-1].hi:
                return j, slot - p[0].lo
        raise IndexError(f"slot {slot} out of range")

    def seat(self, slot: int, a: torch.Tensor, b: torch.Tensor) -> None:
        """Pack one request's canonical (A, B) into ``slot`` on its device
        (in place), zero-padding its sites up to the table's capacity."""
        j, i = self._locate(slot)
        dev = self.parts[j][0].device
        self.a_parts[j][i] = self.runner.pack_lattice(a, dev)
        self.b_parts[j][i] = self.runner.plan.codec.pack_b(b.to(dev))

    def result(self, slot: int, n_sites: int) -> torch.Tensor:
        """Canonical complex C of ``slot``, sliced to the live sites (a new
        tensor, not a view of the table)."""
        j, i = self._locate(slot)
        return self.runner.plan.codec.unpack(self.a_parts[j][i], n_sites)

    def clear(self, slot: int) -> None:
        """Zero a freed slot (its stale lattice would otherwise keep
        stepping and confuse a later occupant's first iteration)."""
        j, i = self._locate(slot)
        self.a_parts[j][i].zero_()
        self.b_parts[j][i].zero_()


class _ChainArrays(_TableArrays):
    """Device-array half of one in-flight chain (scheduling half:
    :class:`~repro_torch.serve.su3.batcher.InflightChain`): ``slots``
    slots padded to the runner's device count, as its ``run`` pads a
    batch (the padding slots are never seated)."""

    def __init__(self, runner: BatchedLatticeRunner, slots: int):
        super().__init__(runner, runner.blocks(slots))

    def advance(self) -> None:
        """One multiply-kernel launch per block (k=1), into NEW tensors:
        the old table stays intact for a rollback."""
        self.a_parts = self.runner.run(self.a_parts, self.b_parts, k=1)


class _SlotTableArrays(_TableArrays):
    """Device-array half of one host's megakernel slot table (scheduling
    half: :class:`~repro_torch.serve.su3.batcher.SlotTable`).

    Every slot is padded to ``cap_L``'s site capacity, so requests of ANY
    L <= cap_L share the one dispatched shape; the whole table advances in
    ONE ``fused_batched_step`` launch per block (whole lattices per device
    of the host's block when ``slots`` divides over it) with per-slot chain
    depths.  Dead slots carry zero lattices and depth 0 (the kernel passes
    them through).

    ``in_place`` lets the kernel write the table in place; a service that
    must roll back after a bad dispatch builds its tables with
    ``in_place=False``, so :meth:`advance` leaves the old table intact.
    """

    def __init__(self, runner: BatchedLatticeRunner, slots: int, max_k: int,
                 in_place: bool = True):
        super().__init__(runner, runner.plan.slot_table_blocks(slots))
        self.slots = slots
        self.max_k = max_k
        self.cap_L = runner.cfg.L
        self._step = runner.plan.fused_batched_step(slots, max_k=max_k, alias=in_place)

    def advance(self, slot_k: list[int]) -> None:
        """ONE megakernel launch per block: slot ``i`` advances
        ``slot_k[i]`` multiplies in-kernel (0 = pass-through).  The depths
        go to each block's card from pinned memory without a host sync (the
        caching host allocator keeps the pinned block until the copy has
        run)."""
        ks = []
        for p, a in zip(self.parts, self.a_parts):
            dev = a.device
            k = torch.tensor(slot_k[p[0].lo:p[-1].hi], dtype=torch.int32,
                             pin_memory=dev.type == "cuda")
            ks.append(k.to(dev, non_blocking=True))
        self.a_parts = self._step(self.a_parts, self.b_parts, ks)


class SU3Service:
    """Dynamic-batching SU3 lattice serving over a warm ExecutionPlan pool.

    Args:
        cfg: the :class:`ServiceConfig` serving tuple.
        device: the device pool: ``"cuda"`` (which must exist), the
            process's cards, host ``h``'s runners on
            ``MeshSpec(hosts).host_devices(h)`` of them; one named card
            (``"cuda:1"``) that every host shares; ``"cpu"``, where the
            kernels' plain versions run; or a list of devices (a card
            repeated oversubscribes it, as the reference does).  Request
            operands land on :attr:`device` (the pool's first device) and
            move to the devices of their host's block at dispatch.
        tracer: optional :class:`repro_torch.obs.Tracer` recording the request
            lifecycle (admit → queue wait → seat → dispatch → complete) and
            per-dispatch spans.  Defaults to the shared disabled tracer —
            every instrumentation site is one ``if tracer.enabled`` branch,
            so untraced serving allocates nothing.
    """

    def __init__(self, cfg: ServiceConfig | None = None,
                 device: torch.device | str | list = "cuda",
                 tracer: Tracer | None = None):
        self.cfg = cfg if cfg is not None else ServiceConfig()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if isinstance(device, (list, tuple)):
            pool = [torch.device(d) for d in device]
            if not pool:
                raise ValueError("the device pool is empty")
        else:
            pool = [torch.device(device)]
        self.device = pool[0]
        if any(d.type == "cuda" for d in pool) and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to serve with the "
                "kernels' plain versions on the CPU"
            )
        if len(pool) == 1 and self.device.type == "cuda" and self.device.index is None:
            pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self._spec, self._pool_devices = MeshSpec(hosts=self.cfg.hosts), pool
        # host h's block of the pool (whole lattices per device) and its
        # lead device, where its solves and request operands go
        self.host_blocks = [self._spec.host_devices(h, pool) for h in range(self.cfg.hosts)]
        self.host_devices = [block[0] for block in self.host_blocks]
        self.device = self.host_devices[0] if self.device.type == "cuda" else self.device
        self.router = LocalityRouter(self.cfg.hosts)
        self._batchers = [
            DynamicBatcher(self.cfg.batcher) for _ in range(self.cfg.hosts)
        ]
        self.batcher = self._batchers[0]  # host 0; aggregate depth: queued()
        self.metrics = ServiceMetrics()
        self._pool: dict[tuple, BatchedLatticeRunner] = {}
        self._ecfg: dict[int, EngineConfig] = {}  # L -> resolved plan tuple
        self._tuned_k: dict[int, int] = {}
        self._results: dict[int, Any] = {}
        # (host, L, dtype, layout, tile) -> batched stencil dispatch
        self._stencil_steps: dict[tuple, Any] = {}
        # (host, group) kind fairness: the kind that group's LAST turn on
        # the host served; the next turn serves the first pending kind
        # strictly after it in the multiply -> stencil -> solve rotation,
        # so within one (tenant, class) group no sustained stream of one
        # kind starves the others.  WHICH group owns a turn is the deficit
        # fair scheduler's call (replacing the old global kind rotation).
        self._last_kind: dict[tuple[int, GroupKey], str] = {}
        self._sched = DeficitFairScheduler(weight_for=self.cfg.slo.weight_for)
        # per-host active solve: ONE data-dependent CG solve advanced a few
        # iterations per scheduling turn (kind="solve" seat)
        self._solves: dict[int, dict[str, Any]] = {}
        self._awaited: set[int] = set()  # ids owned by pending arun callers
        self._seen_shapes: set[tuple] = set()
        self._next_id = 0
        self._rr_host = 0  # round-robin cursor over hosts for step()
        # continuous mode: (host, L) -> (InflightChain, _ChainArrays)
        self._chains: dict[tuple[int, int], tuple[InflightChain, _ChainArrays]] = {}
        # megakernel mode: host -> (SlotTable, _SlotTableArrays)
        self._tables: dict[int, tuple[SlotTable, _SlotTableArrays]] = {}
        # -- robustness state ---------------------------------------------------
        self.faults = self.cfg.faults if self.cfg.faults is not None \
            else NULL_FAULT_PLAN
        # a dispatch that may be rolled back writes a new slot table; the
        # kernel writes in place only when nothing can ask for a rollback
        self._guarded = self.faults.enabled or self.cfg.numerics_guard
        self.health = HostHealth(self.cfg.hosts, self.cfg.quarantine_after)
        self._retry_rng = random.Random(self.cfg.retry.seed)
        self._retry_budget = self.cfg.retry.budget
        # requests waiting out a backoff: (eligible perf_counter s, request)
        self._retry_q: list[tuple[float, ServeRequest]] = []
        # set the first time any request carries a deadline, so the
        # deadline-free hot path never scans queues/seats for expiry
        self._deadlines_armed = bool(
            self.cfg.default_deadline_s
            or self.cfg.slo.latency_deadline_s
            or self.cfg.slo.bulk_deadline_s)
        # -- tenancy state ------------------------------------------------------
        self._quota_buckets: dict[str, TokenBucket] = {}
        self._brownout = BrownoutLadder(self.cfg.brownout) \
            if self.cfg.brownout is not None else None
        if self.cfg.autoscale.enabled:
            self._autoscaler: WarmPoolAutoscaler | None = WarmPoolAutoscaler(
                self.cfg.autoscale, self.cfg.hosts)
            self._active_hosts = self.cfg.autoscale.min_hosts
        else:
            self._autoscaler = None
            self._active_hosts = self.cfg.hosts
        self.metrics.active_hosts = self._active_hosts

    # -- warm pool -----------------------------------------------------------

    def _engine_config(self, L: int) -> EngineConfig:
        """Resolved plan tuple for L, memoized — the autotune path otherwise
        re-reads the JSON cache file on every dispatch."""
        if L not in self._ecfg:
            cfg = self.cfg
            if cfg.autotune:
                self._ecfg[L] = autotune.tuned_engine_config(
                    L=L, dtype=cfg.dtype, cache_directory=cfg.cache_directory,
                    device=self.device, layout=cfg.layout,
                    accum_dtype=cfg.accum_dtype, compression=cfg.compression,
                )
            else:
                self._ecfg[L] = EngineConfig(
                    L=L, dtype=cfg.dtype, layout=cfg.layout,
                    tile=cfg.tile or DEFAULT_TILE, accum_dtype=cfg.accum_dtype,
                    compression=cfg.compression,
                )
        return self._ecfg[L]

    def runner_for(self, L: int, host: int | None = None) -> BatchedLatticeRunner:
        """The warm runner for lattice size L on its home host.

        Args:
            L: lattice extent (requests carry L**4 sites).
            host: explicit host override; default = the router's sticky
                home for L (assigned least-loaded-first on first sight).

        Returns:
            The host-local :class:`BatchedLatticeRunner` (built + autotuned
            on first use; warm afterwards).
        """
        if host is None:
            host = self._home(L)
        ecfg = self._engine_config(L)
        key = (host, L, ecfg.dtype, ecfg.layout.value, ecfg.tile, ecfg.compression)
        runner = self._pool.get(key)
        if runner is None:
            if self.faults.enabled:
                # "pool" seam: warm-runner construction fails (a host that
                # cannot build/allocate its plan).  The build is retried
                # immediately — charged as one retry — and repeated cold-
                # build failures walk the host toward quarantine.
                f = self.faults.ask("pool", host=host, L=L)
                if f is not None:
                    self.metrics.record_fault()
                    self.metrics.record_retry()
                    if self.tracer.enabled:
                        self.tracer.event("chaos.fault", lane=host,
                                          site="pool", action=f.action,
                                          seq=f.seq, host=host, L=L)
                    if self.health.record_failure(host, "pool-build"):
                        self._quarantine(host)
            runner = BatchedLatticeRunner(
                ecfg, self._spec.host_submesh(host, self._pool_devices))
            self._pool[key] = runner
        return runner

    def _serving_hosts(self) -> list[int]:
        """Hosts eligible for new work: active (autoscaler set) and not
        quarantined.  Never empty — if quarantine has eaten the whole
        active set, the healthy hosts beyond it serve (HostHealth never
        quarantines the last healthy host)."""
        hosts = [
            h for h in range(self._active_hosts)
            if not self.health.is_quarantined(h)
        ]
        return hosts or self.health.healthy_hosts()

    def _home(self, L: int) -> int:
        """The lattice size's home host, re-homed deterministically onto a
        serving host when the sticky assignment is quarantined or scaled
        out of the active pool."""
        host = self.router.host_for(L)
        serving = self._serving_hosts()
        if host not in serving:
            host = serving[L % len(serving)]
        return host

    def pool_keys(self) -> list[tuple]:
        """Sorted warm-pool keys:
        ``(host, L, dtype, layout, tile, compression)``."""
        return sorted(self._pool)

    def default_k_for(self, L: int) -> int:
        """Request chain depth when unspecified: configured or autotuned."""
        if self.cfg.default_k:
            return self.cfg.default_k
        if not self.cfg.autotune:
            return 1
        if L not in self._tuned_k:
            self._tuned_k[L] = autotune.tuned_fused_k(
                L=L, dtype=self.cfg.dtype, accum_dtype=self.cfg.accum_dtype,
                compression=self.cfg.compression,
                cache_directory=self.cfg.cache_directory, device=self.device,
            )
        return self._tuned_k[L]

    def _chain_slots(self) -> int:
        return self.cfg.chain_slots or self.cfg.batcher.padded_size(
            self.cfg.batcher.max_batch
        )

    def warm(self, Ls: tuple[int, ...], ks: tuple[int, ...] = (1,),
             batch_sizes: tuple[int, ...] = (), stencil: bool = False) -> None:
        """Pre-build runners (and optionally run each dispatch shape once).

        Serving cold-start control: the first touch of a shape — the CUDA
        kernels' build at first use, the autotune sweep, the allocations —
        happens here instead of inside a user request's latency.  In
        continuous mode this also runs the (chain_slots, k=1) iteration
        shape each chain re-dispatches.  ``stencil=True`` additionally runs
        the batched stencil dispatch at each warm batch size.
        """
        for L in Ls:
            runner = self.runner_for(L)
            n_sites = L**4
            dev = runner.device
            for bsz in batch_sizes:
                a = torch.zeros((bsz, n_sites, 4, 3, 3), dtype=torch.complex64, device=dev)
                b = torch.zeros((bsz, 4, 3, 3), dtype=torch.complex64, device=dev)
                for k in ks:
                    _sync(runner.multiply(a, b, k=k))
                    self._seen_shapes.add(self._shape_key(runner, L, k, bsz))
                if stencil:
                    host = self.router.host_for(L)
                    v = torch.zeros((bsz, n_sites, 3), dtype=torch.complex64, device=dev)
                    step = self._stencil_step_for(runner, host, L)
                    _sync(step(runner.pack_batch(a), runner.pack_vec_batch(v)))
                    self._seen_shapes.add(("stencil", L, runner.padded(bsz)))
            if self.cfg.megakernel:
                # per-slot depths are data, so ONE table shape at this
                # capacity serves every (k mix, admission pattern)
                slots = self._chain_slots()
                arrays = _SlotTableArrays(runner, slots, max_k=self.cfg.chain_horizon,
                                          in_place=not self._guarded)
                arrays.advance([0] * slots)
                _sync(arrays.a_parts)
                self._seen_shapes.add(("mega", L, slots, self.cfg.chain_horizon))
            elif self.cfg.continuous:
                arrays = _ChainArrays(runner, self._chain_slots())
                arrays.advance()
                _sync(arrays.a_parts)
                self._seen_shapes.add(
                    self._shape_key(runner, L, 1, self._chain_slots())
                )

    @staticmethod
    def _shape_key(runner: BatchedLatticeRunner, L: int, k: int, bsz: int) -> tuple:
        """Dispatch-shape identity (a shape seen before is "warm"): the
        batch padded to a multiple of the host's devices, as the reference
        pads it."""
        return (L, k, runner.padded(bsz))

    # -- tracing -------------------------------------------------------------

    def _trace_dispatch(self, runner: BatchedLatticeRunner, host: int,
                        kind: str, L: int, k: int, mode: str, t0: float,
                        step_s: float, live: int, padded: int, flops: float,
                        cold: bool) -> None:
        """One retroactive dispatch span (the timed block already ran —
        zero extra clock reads on the hot path).  Callers guard with
        ``if self.tracer.enabled``."""
        ecfg = runner.cfg
        self.tracer.add_span(
            "dispatch", t0, t0 + step_s, lane=host,
            kind=kind, mode=mode, host=host, L=L, k=k,
            tile=ecfg.tile, dtype=ecfg.dtype, compression=ecfg.compression,
            live=live, padded=padded, flops=flops, cold=cold)

    def _trace_request(self, req: ServeRequest, done_s: float, host: int,
                       mode: str) -> None:
        """Whole-lifecycle span for one completed request: admission →
        completion, with the queue wait (admit → first seat) as an attr."""
        seated = req.seated_s or req.arrival_s
        self.tracer.add_span(
            "request", req.arrival_s, done_s, lane=_request_lane(req.req_id),
            req_id=req.req_id, kind=req.kind, L=req.L, k=req.k, host=host,
            mode=mode, queue_wait_s=seated - req.arrival_s)

    # -- request intake ------------------------------------------------------

    @staticmethod
    def _infer_L(a: torch.Tensor) -> int:
        n_sites = a.shape[0]
        L = round(n_sites ** 0.25)
        if L**4 != n_sites or tuple(a.shape[1:]) != (4, 3, 3):
            raise ValueError(
                f"request lattice must be (L**4, 4, 3, 3) canonical complex, "
                f"got {a.shape}"
            )
        return L

    def queued(self) -> int:
        """Total waiting requests across every host's batcher."""
        return sum(len(b) for b in self._batchers)

    def _deadline(self, deadline_s: float | None, arrival_s: float,
                  slo: str = SLO_BULK) -> float:
        """Absolute deadline for a request: its own relative deadline, else
        the SLO class's default, else the service-wide default, else none
        (0.0)."""
        d = deadline_s
        if d is None:
            d = self.cfg.slo.deadline_for(slo) or self.cfg.default_deadline_s
        if d and d > 0:
            self._deadlines_armed = True
            return arrival_s + d
        return 0.0

    @staticmethod
    def _resolve_slo(kind: str, slo: str | None) -> str:
        """The request's SLO class: explicit, else the kind's default."""
        if slo is None:
            return DEFAULT_KIND_SLO[kind]
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"slo must be one of {SLO_CLASSES}, got {slo!r}"
            )
        return slo

    @staticmethod
    def _check_tenant(tenant: str) -> str:
        if not tenant or not isinstance(tenant, str):
            raise ValueError(
                f"tenant must be a non-empty string, got {tenant!r}"
            )
        return tenant

    def _quota_admit(self, tenant: str, now: float) -> bool:
        """Charge the tenant's token bucket; False = quota backpressure
        (the submit returns None before touching any queue)."""
        quotas = self.cfg.quotas
        if not quotas:
            return True
        spec = quotas.get(tenant)
        if spec is None:
            return True
        bucket = self._quota_buckets.get(tenant)
        if bucket is None:
            bucket = self._quota_buckets[tenant] = TokenBucket(spec)
        if bucket.try_take(now):
            return True
        self.metrics.record_quota_reject(tenant)
        if self.tracer.enabled:
            self.tracer.event("quota.reject", lane=0, tenant=tenant)
        return False

    def _brownout_door(self, req: ServeRequest, host: int) -> int | None:
        """The brownout ladder's bulk-lane admission check.  Returns the
        request id when the ladder SHED the arrival (the id resolves
        immediately to a LoadShedError — zero-lost accounting holds, the
        caller can pop the structured error), or None to admit normally.
        Latency-class requests are never browned out."""
        ladder = self._brownout
        if ladder is None or ladder.rung < 1 or req.slo != SLO_BULK:
            return None
        rung = ladder.rung
        retry_after = 0.0
        if rung >= 3:
            retry_after = self.cfg.brownout.retry_after_s
        else:
            # rung 1/2: bulk keeps only a reduced share of the queue budget
            budget = max(1, int(self.cfg.batcher.max_queue_depth
                                * self.cfg.brownout.bulk_queue_fraction))
            if self._batchers[host].depth_for_slo(SLO_BULK) < budget:
                return None
        self._next_id += 1
        self.metrics.record_shed(req.kind, for_kind="brownout",
                                 tenant=req.tenant, slo=req.slo)
        self._results[req.req_id] = LoadShedError(
            req_id=req.req_id, kind=req.kind, priority=req.priority,
            shed_for_kind="brownout", attempts=req.attempts,
            retry_after_s=retry_after)
        if self.tracer.enabled:
            self.tracer.event(
                "brownout.shed", lane=_request_lane(req.req_id),
                req_id=req.req_id, kind=req.kind, tenant=req.tenant,
                rung=rung, retry_after_s=retry_after)
        return req.req_id

    def _shed(self, victim: ServeRequest, for_kind: str) -> None:
        """Deliver a structured LoadShedError to a queue victim evicted to
        admit a higher-priority arrival."""
        self.metrics.record_shed(victim.kind, for_kind=for_kind,
                                 tenant=victim.tenant, slo=victim.slo)
        self._results[victim.req_id] = LoadShedError(
            req_id=victim.req_id, kind=victim.kind, priority=victim.priority,
            shed_for_kind=for_kind, attempts=victim.attempts)
        if self.tracer.enabled:
            self.tracer.event(
                "shed", lane=_request_lane(victim.req_id),
                req_id=victim.req_id, kind=victim.kind)

    def _preempt_bulk(self, occupants: list, evict_fn: Any, host: int) -> bool:
        """Latency-lane seat preemption: evict the youngest-arrival seated
        BULK request to free one slot for a waiting latency-class multiply.
        The victim is not failed — it re-queues on its home batcher (the
        deterministic re-run the quarantine re-seat path already relies on)
        and only resolves as a structured shed if its queue is full."""
        bulk = [(slot, req) for slot, req, _rem in occupants
                if req.slo == SLO_BULK]
        if not bulk:
            return False
        slot, victim = max(bulk, key=lambda t: t[1].arrival_s)
        evict_fn(slot)
        self.metrics.record_preemption()
        if self.tracer.enabled:
            self.tracer.event(
                "preempt", lane=_request_lane(victim.req_id),
                req_id=victim.req_id, kind=victim.kind, host=host, slot=slot,
                tenant=victim.tenant)
        if not self._batchers[host].submit(victim):
            self._shed(victim, "latency-preempt")
        return True

    def _admit(self, req: ServeRequest, host: int, load_flops: float,
               depth: int) -> int | None:
        """Shared admission tail: queue-budget check with priority-aware
        shedding (the youngest strictly-lower-priority BULK-class request
        is evicted — with a structured error — to admit a latency-sensitive
        arrival; the latency lane is never shed), then load/metrics/trace
        accounting."""
        batcher = self._batchers[host]
        if not batcher.submit(req):
            victim = batcher.shed_lowest(req.priority, sheddable_slo=SLO_BULK)
            if victim is not None:
                self._shed(victim, req.kind)
            if victim is None or not batcher.submit(req):
                self.metrics.record_reject(req.kind)
                return None
        self.router.record_load(host, load_flops)
        self._next_id += 1
        self.metrics.record_admit(depth + 1, tenant=req.tenant, slo=req.slo)
        if self.tracer.enabled:
            self.tracer.event(
                "admit", lane=_request_lane(req.req_id), req_id=req.req_id,
                kind=req.kind, L=req.L, k=req.k, host=host, tenant=req.tenant,
                slo=req.slo, queue_depth=depth + 1)
        return req.req_id

    def _tensor(self, x: Any) -> torch.Tensor:
        """A request operand (tensor or numpy) as a tensor on the card."""
        return torch.as_tensor(x).to(self.device)

    def submit(self, a: torch.Tensor, b: torch.Tensor, k: int | None = None,
               deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT,
               slo: str | None = None) -> int | None:
        """Queue one lattice multiply on its home host's batcher.

        Args:
            a: canonical complex lattice ``(L**4, 4, 3, 3)``.
            b: canonical complex link matrix set ``(4, 3, 3)``.
            k: chain depth (``C = A⊗B`` applied k times); None = the
                autotuned default for (backend, L).
            deadline_s: relative deadline; None = the SLO class default,
                else the configured service default.  A request past its
                deadline is evicted wherever it sits and completes with a
                structured ``DeadlineExceededError``.
            tenant: tenant identity (quota metering + fairness group);
                every pre-tenancy call site rides the default tenant.
            slo: SLO class ("latency"/"bulk"); None = the kind's default
                (multiplies are bulk).

        Returns:
            A request id, or None when the tenant's quota bucket is dry or
            the home host's queue budget is exhausted (backpressure —
            caller retries later) and nothing lower-priority could be shed
            to make room.  Under brownout the id may resolve immediately
            to a ``LoadShedError`` carrying a Retry-After hint.
        """
        a, b = self._tensor(a), self._tensor(b)
        L = self._infer_L(a)
        tenant = self._check_tenant(tenant)
        slo = self._resolve_slo("multiply", slo)
        host = self._home(L)
        depth = self.queued()
        arrival = time.perf_counter()
        if not self._quota_admit(tenant, arrival):
            return None
        req = ServeRequest(
            req_id=self._next_id, a=a, b=b, L=L,
            k=k if k is not None else self.default_k_for(L),
            arrival_s=arrival,
            deadline_s=self._deadline(deadline_s, arrival, slo),
            priority=PRIORITY["multiply"], tenant=tenant, slo=slo,
        )
        shed_id = self._brownout_door(req, host)
        if shed_id is not None:
            return shed_id
        return self._admit(req, host, request_flops(req.n_sites, req.k), depth)

    def submit_stencil(self, u: torch.Tensor, v: torch.Tensor,
                       deadline_s: float | None = None,
                       tenant: str = DEFAULT_TENANT,
                       slo: str | None = None) -> int | None:
        """Queue one nearest-neighbor stencil application on its home host.

        Args:
            u: canonical complex gauge lattice ``(L**4, 4, 3, 3)``.
            v: canonical complex color-vector field ``(L**4, 3)``.

        Returns:
            A request id (result: the canonical ``(L**4, 3)`` output vector
            field), or None under backpressure — same contract as
            :meth:`submit`.  Stencil requests ride the SAME warm pool,
            locality router, and per-host batcher as multiplies; they
            coalesce by lattice size into one stencil dispatch and never
            join multiply chains (their output is a vector field).
        """
        u, v = self._tensor(u), self._tensor(v)
        L = self._infer_L(u)
        if tuple(v.shape) != (L**4, 3):
            raise ValueError(
                f"stencil vector field must be (L**4, 3) canonical complex "
                f"matching the lattice, got {v.shape} for L={L}"
            )
        tenant = self._check_tenant(tenant)
        slo = self._resolve_slo("stencil", slo)
        host = self._home(L)
        depth = self.queued()
        arrival = time.perf_counter()
        if not self._quota_admit(tenant, arrival):
            return None
        req = ServeRequest(
            req_id=self._next_id, a=u, b=v, L=L, k=1,
            arrival_s=arrival, kind="stencil",
            deadline_s=self._deadline(deadline_s, arrival, slo),
            priority=PRIORITY["stencil"], tenant=tenant, slo=slo,
        )
        shed_id = self._brownout_door(req, host)
        if shed_id is not None:
            return shed_id
        return self._admit(
            req, host, float(STENCIL_FLOPS_PER_SITE) * req.n_sites, depth)

    def submit_solve(self, u: torch.Tensor, b: torch.Tensor, tol: float = 1e-6,
                     max_iters: int = 200,
                     deadline_s: float | None = None,
                     tenant: str = DEFAULT_TENANT,
                     slo: str | None = None) -> int | None:
        """Queue one staggered CG solve ``(sigma I + S) x = b`` on its home
        host.

        Args:
            u: canonical complex gauge lattice ``(L**4, 4, 3, 3)``.
            b: canonical complex right-hand side ``(L**4, 3)``.
            tol: relative-residual target ``||r|| <= tol ||b||``.
            max_iters: iteration cap; the request retires (best iterate
                delivered) rather than spinning past it.

        Returns:
            A request id (result: the canonical ``(L**4, 3)`` solution
            field), or None under backpressure — same contract as
            :meth:`submit`.  The solve rides the SAME warm pool, locality
            router, and per-host batcher; its iteration count is
            data-dependent, so it advances ``solve_iters_per_step`` CG
            iterations per scheduling turn through the fused stencil+axpy
            kernel and retires mid-chain when the residual crosses tol.
        """
        u, b = self._tensor(u), self._tensor(b)
        L = self._infer_L(u)
        if tuple(b.shape) != (L**4, 3):
            raise ValueError(
                f"solve right-hand side must be (L**4, 3) canonical complex "
                f"matching the lattice, got {b.shape} for L={L}"
            )
        if tol < 0:
            raise ValueError(f"tol must be >= 0, got {tol}")
        if max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {max_iters}")
        tenant = self._check_tenant(tenant)
        slo = self._resolve_slo("solve", slo)
        host = self._home(L)
        depth = self.queued()
        arrival = time.perf_counter()
        if not self._quota_admit(tenant, arrival):
            return None
        req = ServeRequest(
            req_id=self._next_id, a=u, b=b, L=L, k=1,
            arrival_s=arrival, kind="solve",
            tol=tol, max_iters=max_iters,
            deadline_s=self._deadline(deadline_s, arrival, slo),
            priority=PRIORITY["solve"], tenant=tenant, slo=slo,
        )
        shed_id = self._brownout_door(req, host)
        if shed_id is not None:
            return shed_id
        # nominal admission charge: a typical shifted-CG iteration count;
        # the true data-dependent bill is charged per dispatched chunk
        return self._admit(
            req, host, float(CG_ITER_FLOPS_PER_SITE) * req.n_sites * 10, depth)

    # -- dispatch ------------------------------------------------------------

    def _work_pending(self) -> bool:
        if any(len(b) for b in self._batchers):
            return True
        if self._solves:
            return True
        if self._retry_q:
            return True
        if any(chain.live for chain, _ in self._chains.values()):
            return True
        return any(table.live for table, _ in self._tables.values())

    def pending(self) -> bool:
        """True while any request waits in a queue, a retry backoff, or an
        in-flight chain — the loop condition for external step() drivers."""
        return self._work_pending()

    # -- failure lifecycle ---------------------------------------------------------

    @staticmethod
    def _finite(x: torch.Tensor | list[torch.Tensor]) -> bool:
        return all(bool(torch.isfinite(t).all().item()) for t in _parts(x))

    def _fail(self, req: ServeRequest, err: Exception) -> None:
        """Deliver a structured failure through the result channel: a
        stepping caller gets the exception object from ``pop_result``, an
        ``arun`` caller gets it raised."""
        self._results[req.req_id] = err

    def _timeout(self, req: ServeRequest, now: float,
                 partial: Any = None) -> None:
        self.metrics.record_timeout(req.kind, tenant=req.tenant, slo=req.slo)
        self._fail(req, DeadlineExceededError(
            req_id=req.req_id, kind=req.kind,
            deadline_s=req.deadline_s - req.arrival_s,
            waited_s=now - req.arrival_s, attempts=req.attempts,
            partial=partial))
        if self.tracer.enabled:
            self.tracer.event(
                "timeout", lane=_request_lane(req.req_id), req_id=req.req_id,
                kind=req.kind, waited_s=now - req.arrival_s)

    def _retry_or_fail(self, req: ServeRequest, cause: str,
                       terminal: Exception | None = None) -> bool:
        """Charge one failed attempt: requeue with capped-exponential
        backoff while the per-request cap and the service-wide retry budget
        allow, else deliver the terminal structured error.  Returns True
        when the request was requeued."""
        req.attempts += 1
        policy = self.cfg.retry
        if req.attempts <= policy.max_retries and self._retry_budget > 0:
            self._retry_budget -= 1
            self.metrics.record_retry()
            delay = policy.backoff_s(req.attempts, self._retry_rng)
            self._retry_q.append((time.perf_counter() + delay, req))
            if self.tracer.enabled:
                self.tracer.event(
                    "retry", lane=_request_lane(req.req_id),
                    req_id=req.req_id, attempt=req.attempts, cause=cause,
                    backoff_s=delay)
            return True
        self.metrics.record_retries_exhausted()
        if terminal is None:
            terminal = RetriesExhaustedError(
                req_id=req.req_id, kind=req.kind, attempts=req.attempts,
                cause=cause,
                budget_exhausted=(self._retry_budget <= 0
                                  and req.attempts <= policy.max_retries))
        self._fail(req, terminal)
        return False

    def _charge_seated(self, occupants: list, evict_fn: Any,
                       cause: str) -> None:
        """Charge one failed dispatch to every seated occupant of a chain or
        slot table: seated requests KEEP their seats while attempts remain
        (the next turn re-dispatches the same state, bitwise clean); past
        the per-request cap — or with the service retry budget dry — they
        are evicted with a structured error.  One budget unit covers the
        whole failed dispatch, not one per occupant."""
        policy = self.cfg.retry
        budget_dry = self._retry_budget <= 0
        if not budget_dry:
            self._retry_budget -= 1
            self.metrics.record_retry()
        for slot, req, _rem in occupants:
            req.attempts += 1
            if budget_dry or req.attempts > policy.max_retries:
                evict_fn(slot)
                self.metrics.record_retries_exhausted()
                self._fail(req, RetriesExhaustedError(
                    req_id=req.req_id, kind=req.kind, attempts=req.attempts,
                    cause=cause, budget_exhausted=budget_dry))

    def _drain_retry_queue(self, now: float) -> None:
        """Move backoff-expired requests back into their (healthy) home
        host's queue; a still-full queue waits another beat rather than
        dropping the request (the deadline sweep bounds that wait)."""
        still: list[tuple[float, ServeRequest]] = []
        for eligible_s, req in self._retry_q:
            if eligible_s > now:
                still.append((eligible_s, req))
            elif not self._batchers[self._home(req.L)].submit(req):
                still.append((now + self.cfg.retry.base_s, req))
        self._retry_q = still

    def _evict_expired(self, now: float) -> None:
        """The deadline sweep: evict every expired request wherever it sits
        — queued, waiting out a backoff, seated in a live chain/table slot,
        or the active solve — and deliver structured timeouts.  Freed seats
        are immediately admissible (the same re-seating machinery mid-chain
        admission uses)."""
        for batcher in self._batchers:
            for req in batcher.evict_expired(now):
                self._timeout(req, now)
        if self._retry_q:
            keep = []
            for eligible_s, req in self._retry_q:
                if req.deadline_s and req.deadline_s <= now:
                    self._timeout(req, now)
                else:
                    keep.append((eligible_s, req))
            self._retry_q = keep
        for host in list(self._solves):
            active = self._solves[host]
            req = active["req"]
            if req.deadline_s and req.deadline_s <= now:
                # best iterate so far rides out as the timeout's partial
                partial = active["plan"].unpack_vec(active["state"]["x"])
                del self._solves[host]
                self._timeout(req, now, partial=partial)
        for chain, arrays in self._chains.values():
            for slot, req, _rem in chain.occupants():
                if req.deadline_s and req.deadline_s <= now:
                    chain.evict(slot)
                    arrays.clear(slot)
                    self._timeout(req, now)
        for table, arrays in self._tables.values():
            for slot, req, _rem in table.occupants():
                if req.deadline_s and req.deadline_s <= now:
                    table.evict(slot)
                    arrays.clear(slot)
                    self._timeout(req, now)

    def _drain_host(self, host: int) -> list[ServeRequest]:
        """Pull every request ``host`` holds — queued, the active solve, and
        seated chain/table slots — off the host (mid-chain progress is
        discarded; the re-run is deterministic).  Shared by the quarantine
        and scale-down paths."""
        moved: list[ServeRequest] = list(self._batchers[host].drain())
        active = self._solves.pop(host, None)
        if active is not None:
            moved.append(active["req"])
        for key in [k for k in self._chains if k[0] == host]:
            chain, arrays = self._chains.pop(key)
            for slot, req, _rem in chain.occupants():
                chain.evict(slot)
                arrays.clear(slot)
                moved.append(req)
        entry = self._tables.pop(host, None)
        if entry is not None:
            table, arrays = entry
            for slot, req, _rem in table.occupants():
                table.evict(slot)
                arrays.clear(slot)
                moved.append(req)
        return moved

    def _reseat(self, moved: list[ServeRequest], cause: str) -> int:
        """Re-seat displaced requests onto serving hosts; returns the count
        that landed.  A request whose deadline has ALREADY passed resolves
        as a DeadlineExceededError right here — exactly once — instead of
        being resubmitted only for the next sweep to evict it (the
        deadline-expiry x re-seat race).  Re-seats that bounce off a full
        queue fail structurally."""
        now = time.perf_counter()
        reseated = 0
        for req in moved:
            if req.deadline_s and req.deadline_s <= now:
                self._timeout(req, now)
                continue
            target = self._home(req.L)
            if self._batchers[target].submit(req):
                reseated += 1
            else:
                self.metrics.record_retries_exhausted()
                self._fail(req, RetriesExhaustedError(
                    req_id=req.req_id, kind=req.kind, attempts=req.attempts,
                    cause=cause))
        return reseated

    def _quarantine(self, host: int) -> None:
        """Last rung of the degradation ladder: the health tracker latched
        ``host`` out.  Every request it holds re-seats onto a healthy host
        via :meth:`_reseat` (``_home`` already excludes the latched host)."""
        moved = self._drain_host(host)
        reseated = self._reseat(
            moved, "quarantine re-seat rejected under backpressure")
        self.metrics.record_quarantine(reseated=reseated)
        if self.tracer.enabled:
            self.tracer.event(
                "chaos.quarantine", lane=host, host=host, reseated=reseated,
                cause=self.health.last_cause[host])

    def _dispatch_fault(self, host: int, kind: str, mode: str):
        """Consult the ``dispatch`` seam.  Returns the Fault only for the
        "fail" action (the caller runs its failure path); "delay" is applied
        here — a stalled-rank injection, the launch still runs."""
        f = self.faults.ask("dispatch", host=host, kind=kind, mode=mode)
        if f is None:
            return None
        self.metrics.record_fault()
        if self.tracer.enabled:
            self.tracer.event(
                "chaos.fault", lane=host, site="dispatch", action=f.action,
                seq=f.seq, host=host, kind=kind, mode=mode)
        if f.action == "delay":
            time.sleep(f.delay_s)
            return None
        return f

    def _poison_output(self, x: torch.Tensor | list[torch.Tensor], host: int,
                       kind: str) -> torch.Tensor | list[torch.Tensor]:
        """Consult the ``kernel`` seam; a fired fault poisons the dispatch
        output (its first device's tensor, for a batch on several) with
        NaN/Inf for the finiteness guard to catch (in a new tensor: ``x``
        stays as the kernel wrote it)."""
        f = self.faults.ask("kernel", host=host, kind=kind)
        if f is None:
            return x
        self.metrics.record_fault()
        if self.tracer.enabled:
            self.tracer.event(
                "chaos.fault", lane=host, site="kernel", action=f.action,
                seq=f.seq, host=host, kind=kind)
        if isinstance(x, torch.Tensor):
            return poison_array(x, f.action)
        return [poison_array(x[0], f.action), *x[1:]]

    def _host_busy(self, host: int) -> bool:
        """A live seat on ``host``: the active solve, a live chain, or a
        live slot table (the occupancy half of the pressure signal)."""
        if host in self._solves:
            return True
        if self.cfg.megakernel:
            entry = self._tables.get(host)
            return bool(entry and entry[0].live)
        if self.cfg.continuous:
            return any(
                h == host and chain.live
                for (h, _L), (chain, _a) in self._chains.items()
            )
        return False

    def _seated_latency(self, host: int) -> bool:
        """True when ``host`` holds a seated latency-class request (a shrink
        must never evict one — the veto the autoscaler docs promise)."""
        active = self._solves.get(host)
        if active is not None and active["req"].slo == SLO_LATENCY:
            return True
        for (h, _L), (chain, _a) in self._chains.items():
            if h == host and any(
                    req.slo == SLO_LATENCY
                    for _s, req, _rem in chain.occupants()):
                return True
        entry = self._tables.get(host)
        if entry is not None and any(
                req.slo == SLO_LATENCY
                for _s, req, _rem in entry[0].occupants()):
            return True
        return False

    def _scale_down(self) -> None:
        """Retire the top active host: drain its queued/seated work onto the
        remaining hosts (the quarantine re-seat machinery).  Vetoed when the
        victim holds a seated latency request — the controller proposes
        again after its next cold streak."""
        victim = self._active_hosts - 1
        if self._seated_latency(victim):
            if self.tracer.enabled:
                self.tracer.event("scale.veto", lane=victim, host=victim)
            return
        self._active_hosts -= 1  # _home() now excludes the victim
        moved = self._drain_host(victim)
        reseated = self._reseat(
            moved, "scale-down re-seat rejected under backpressure")
        self.metrics.record_scale(-1, self._active_hosts)
        if self.tracer.enabled:
            self.tracer.event(
                "scale.down", lane=victim, host=victim,
                active=self._active_hosts, reseated=reseated)

    def _observe_pressure(self) -> None:
        """One control-loop sample per step(): feed the brownout ladder and
        the warm-pool autoscaler the same load signals — queued fraction of
        the active queue budget, blended with seat occupancy while a
        backlog exists — and apply their decisions.  Both controllers are
        functions of the observation SEQUENCE, so a same-seed replay of the
        same traffic reproduces every transition and scale event."""
        active = self._serving_hosts()
        n = max(1, len(active))
        depth = self.queued()
        cap = max(1, self.cfg.batcher.max_queue_depth) * n
        occupancy = sum(1 for h in active if self._host_busy(h)) / n
        pressure = min(1.0, depth / cap)
        if depth:
            pressure = max(pressure, occupancy)
        if self._brownout is not None:
            new_rung = self._brownout.observe(pressure)
            self.metrics.record_brownout_turn(self._brownout.rung)
            if new_rung is not None:
                self.metrics.record_brownout_transition(new_rung)
                if self.tracer.enabled:
                    t = self._brownout.transitions[-1]
                    self.tracer.event(
                        "brownout.transition", lane=0, rung=new_rung,
                        from_rung=t["from"], pressure=t["pressure"])
        if self._autoscaler is not None:
            delta = self._autoscaler.observe(
                depth_per_host=depth / n, occupancy=occupancy,
                active=self._active_hosts)
            if delta > 0:
                self._active_hosts += 1
                self.metrics.record_scale(+1, self._active_hosts)
                if self.tracer.enabled:
                    self.tracer.event(
                        "scale.up", lane=0, active=self._active_hosts)
            elif delta < 0:
                self._scale_down()

    def step(self) -> int:
        """Advance the service by one scheduling turn; returns completed
        request count.

        Turn ownership is two-level.  The deficit-weighted fair scheduler
        first picks WHICH (tenant, SLO class) group owns the turn on the
        next host with pending work — every pending group accrues
        weight-proportional credit, so a backlogged bulk tenant cannot
        monopolize turns and a pending latency group is served within a
        provable bound (tests/test_tenancy.py pins it).  Within the granted
        group, kinds rotate multiply -> stencil -> solve exactly as before
        — per (host, group) now — so no sustained stream of one kind
        starves the others *inside* a group.  Dispatch is unchanged:
        batch-per-step serves one coalesced (L, k) bucket from the group's
        buckets; continuous admits the group's waiters at the iteration
        boundary then advances ALL the host's live chains; megakernel
        slot-swaps then fires one batched K-chain dispatch.  Each step also
        feeds one pressure sample to the brownout ladder and the warm-pool
        autoscaler (when configured).
        """
        now = time.perf_counter()
        if self._retry_q:
            self._drain_retry_queue(now)
        if self._deadlines_armed:
            self._evict_expired(now)
        if self._brownout is not None or self._autoscaler is not None:
            self._observe_pressure()
        order = ("multiply", "stencil", "solve")
        for _ in range(self.cfg.hosts):
            host = self._rr_host
            self._rr_host = (self._rr_host + 1) % self.cfg.hosts
            if self.health.is_quarantined(host):
                continue
            groups = self._pending_groups(host)
            if not groups:
                continue
            group = self._sched.next_group(sorted(groups))
            if group is None:  # pragma: no cover - groups is non-empty
                continue
            pending = groups[group]
            last = self._last_kind.get((host, group), "multiply")
            start = order.index(last) if last in order else 0
            for off in range(1, len(order) + 1):
                kind = order[(start + off) % len(order)]
                if kind not in pending:
                    continue
                self._last_kind[(host, group)] = kind
                if kind == "stencil":
                    return self._step_stencil(host, group)
                if kind == "solve":
                    return self._step_solve(host, group)
                if self.cfg.megakernel:
                    return self._step_megakernel(host, group)
                if self.cfg.continuous:
                    return self._step_continuous(host, group)
                return self._step_batch(host, group)
        return 0

    def _pending_groups(self, host: int) -> dict[GroupKey, set[str]]:
        """Pending work on ``host`` keyed by (tenant, SLO class) group, each
        with its waiting kinds.  Live chain/table seats count as multiply
        work for their occupants' groups; the single active solve counts
        for ITS group only and suppresses other groups' queued solves (one
        solve seat per host — their turn comes when it retires)."""
        groups = {
            g: set(kinds)
            for g, kinds in
            self._batchers[host].pending_kinds_by_group().items()
        }
        active = self._solves.get(host)
        if active is not None:
            owner = active["req"].group
            for g, kinds in groups.items():
                if g != owner:
                    kinds.discard("solve")
            groups.setdefault(owner, set()).add("solve")
        if self.cfg.megakernel:
            entry = self._tables.get(host)
            if entry is not None:
                for _slot, req, _rem in entry[0].occupants():
                    groups.setdefault(req.group, set()).add("multiply")
        elif self.cfg.continuous:
            for (h, _L), (chain, _arr) in self._chains.items():
                if h != host:
                    continue
                for _slot, req, _rem in chain.occupants():
                    groups.setdefault(req.group, set()).add("multiply")
        return {g: kinds for g, kinds in groups.items() if kinds}

    def _step_batch(self, host: int, group: GroupKey | None = None) -> int:
        """One coalesced fused-k dispatch for ``host`` (batch-per-step),
        drawn from ``group``'s buckets when the fair scheduler granted the
        turn to a specific (tenant, class) group."""
        batch = self._batchers[host].next_batch(group=group)
        if batch is None:
            return 0
        reqs = batch.requests
        runner = self.runner_for(batch.L, host)
        n_sites = batch.L**4
        if self.faults.enabled:
            f = self._dispatch_fault(host, "multiply", "batch")
            if f is not None:
                # launch failed: every popped request goes down the retry
                # path (backoff requeue, or structured exhaustion)
                quarantined = self.health.record_failure(host, "dispatch")
                for r in reqs:
                    self._retry_or_fail(r, "injected dispatch failure")
                if quarantined:
                    self._quarantine(host)
                return 0
        a = torch.stack([r.a for r in reqs])
        b = torch.stack([r.b for r in reqs])
        if batch.pad:
            a = torch.cat([a, a.new_zeros((batch.pad,) + tuple(a.shape[1:]))])
            b = torch.cat([b, b.new_zeros((batch.pad,) + tuple(b.shape[1:]))])
        shape_key = self._shape_key(runner, batch.L, batch.k, batch.padded_size)
        cold = shape_key not in self._seen_shapes
        t0 = time.perf_counter()
        c = runner.multiply(a, b, k=batch.k)
        if self.faults.enabled:
            c = self._poison_output(c, host, "multiply")
        _sync(c)
        step_s = time.perf_counter() - t0
        if (self.faults.enabled or self.cfg.numerics_guard) \
                and not self._finite(c):
            # poisoned (or genuinely non-finite) output: never delivered —
            # the batch re-runs through the retry path, bitwise clean
            quarantined = self.health.record_failure(host, "non-finite output")
            for r in reqs:
                self._retry_or_fail(r, "non-finite kernel output")
            if quarantined:
                self._quarantine(host)
            return 0
        if self.faults.enabled or self.cfg.numerics_guard:
            self.health.record_success(host)
        self._seen_shapes.add(shape_key)
        self.metrics.record_dispatch(
            live=len(reqs), padded=batch.padded_size, step_s=step_s,
            flops=request_flops(n_sites, batch.k) * len(reqs), cold=cold,
            host=host,
        )
        if self.tracer.enabled:
            self._trace_dispatch(
                runner, host, "multiply", batch.L, batch.k, "batch", t0,
                step_s, live=len(reqs), padded=batch.padded_size,
                flops=request_flops(n_sites, batch.k) * len(reqs), cold=cold)
        done_s = time.perf_counter()
        for i, r in enumerate(reqs):
            self._results[r.req_id] = c[i]
            self.metrics.record_completion(
                done_s - r.arrival_s, tenant=r.tenant, slo=r.slo)
            if self.tracer.enabled:
                r.seated_s = t0  # batch mode: seating IS the dispatch start
                self._trace_request(r, done_s, host, "batch")
        self.metrics.record_queue_depth(self.queued())
        return len(reqs)

    def _stencil_step_for(self, runner: BatchedLatticeRunner, host: int, L: int):
        """The host's batched stencil dispatch for L — built once per
        warm-pool entry from the plan's reference stencil
        (``plan.raw_stencil_reference()``: the neighbour gather, then ONE
        stencil kernel launch).  The batch comes in the runner's blocks
        (``pack_batch`` / ``pack_vec_batch``: whole lattices per device of
        the host's block) and each lattice runs on its block's device,
        through the runner's plan there.  The stencil kernel has no batch
        axis, so the batch runs one gather and one launch per lattice, each
        into a fresh output."""
        ecfg = runner.cfg
        key = (host, L, ecfg.dtype, ecfg.layout.value, ecfg.tile, ecfg.compression)
        step = self._stencil_steps.get(key)
        if step is None:
            refs: dict[torch.device, Any] = {}

            def step(u_phys, v_p):
                held = sum(x.shape[0] for x in _parts(u_phys))
                outs = []
                for part, us, vs in zip(device_parts(runner.blocks(held)), _parts(u_phys),
                                        _parts(v_p)):
                    dev = part[0].device
                    if dev not in refs:
                        refs[dev] = runner.plan_on(dev).raw_stencil_reference()
                    outs.append(torch.stack([refs[dev](u, v) for u, v in zip(us, vs)]))
                return outs[0] if isinstance(u_phys, torch.Tensor) else outs

            self._stencil_steps[key] = step
        return step

    def _step_stencil(self, host: int, group: GroupKey | None = None) -> int:
        """One coalesced stencil dispatch for ``host``: the granted group's
        oldest waiting lattice size, through the warm runner's plan."""
        batch = self._batchers[host].next_stencil_batch(group=group)
        if batch is None:
            return 0
        reqs = batch.requests
        runner = self.runner_for(batch.L, host)
        plan = runner.plan
        n_sites = batch.L**4
        if self.faults.enabled:
            f = self._dispatch_fault(host, "stencil", "batch")
            if f is not None:
                quarantined = self.health.record_failure(host, "dispatch")
                for r in reqs:
                    self._retry_or_fail(r, "injected dispatch failure")
                if quarantined:
                    self._quarantine(host)
                return 0
        # warm-size padding (the batcher's warm shapes) + device-multiple
        # padding (whole lattices per device of the host's block; pack_batch
        # pads to it)
        dispatched = runner.padded(batch.padded_size)
        pad = batch.padded_size - len(reqs)
        u = torch.stack([r.a for r in reqs])
        v = torch.stack([r.b for r in reqs])
        if pad:
            u = torch.cat([u, u.new_zeros((pad,) + tuple(u.shape[1:]))])
            v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        u_phys = runner.pack_batch(u)
        v_p = runner.pack_vec_batch(v)
        step = self._stencil_step_for(runner, host, batch.L)
        shape_key = ("stencil", batch.L, dispatched)
        cold = shape_key not in self._seen_shapes
        t0 = time.perf_counter()
        out_p = step(u_phys, v_p)
        if self.faults.enabled:
            out_p = self._poison_output(out_p, host, "stencil")
        _sync(out_p)
        step_s = time.perf_counter() - t0
        if (self.faults.enabled or self.cfg.numerics_guard) \
                and not self._finite(out_p):
            quarantined = self.health.record_failure(host, "non-finite output")
            for r in reqs:
                self._retry_or_fail(r, "non-finite kernel output")
            if quarantined:
                self._quarantine(host)
            return 0
        if self.faults.enabled or self.cfg.numerics_guard:
            self.health.record_success(host)
        self._seen_shapes.add(shape_key)
        self.metrics.record_dispatch(
            live=len(reqs), padded=dispatched, step_s=step_s,
            flops=float(STENCIL_FLOPS_PER_SITE) * n_sites * len(reqs),
            cold=cold, host=host,
        )
        if self.tracer.enabled:
            self._trace_dispatch(
                runner, host, "stencil", batch.L, 1, "batch", t0, step_s,
                live=len(reqs), padded=dispatched,
                flops=float(STENCIL_FLOPS_PER_SITE) * n_sites * len(reqs),
                cold=cold)
        done_s = time.perf_counter()
        outs = [x for part in _parts(out_p) for x in part]
        for i, r in enumerate(reqs):
            self._results[r.req_id] = plan.codec.unpack_vec(outs[i], n_sites)
            self.metrics.record_completion(
                done_s - r.arrival_s, tenant=r.tenant, slo=r.slo)
            if self.tracer.enabled:
                r.seated_s = t0
                self._trace_request(r, done_s, host, "batch")
        self.metrics.record_queue_depth(self.queued())
        return len(reqs)

    def _seat_solve(self, host: int,
                    group: GroupKey | None = None) -> dict[str, Any] | None:
        """Pop the granted group's oldest queued solve and seat it as the
        active one: pack the gauge field and right-hand side through the
        warm runner's plan, initialize the CG state, and pin the
        convergence threshold ``||r||^2 <= tol^2 ||b||^2`` from the packed
        b."""
        req = self._batchers[host].next_solve(group=group)
        if req is None:
            return None
        runner = self.runner_for(req.L, host)
        if (self._brownout is not None and self._brownout.rung >= 2
                and self.cfg.brownout.degrade_bulk_bf16
                and req.slo == SLO_BULK
                and runner.cfg.dtype != "bfloat16"):
            # rung 2 degradation: a BULK solve rides a warm bf16-storage
            # plan when the pool already holds one for this (host, L) —
            # never builds a new plan mid-overload
            for key, cand in self._pool.items():
                if key[0] == host and key[1] == req.L \
                        and key[2] == "bfloat16":
                    runner = cand
                    break
        plan = runner.plan
        u_phys = plan.pack_gauge(req.a)
        b_p = plan.pack_rhs(req.b)
        state = plan.cg_state_init(b_p)
        b_rs = float(state["rs"].item())  # r_0 = b, so rs_0 = ||b||^2
        active = {
            "req": req, "plan": plan, "runner": runner, "u_phys": u_phys,
            "state": state, "b_rs": b_rs, "stop2": req.tol * req.tol * b_rs,
            "best": None,  # (rs_host, x) — carried on structured failures
        }
        self._solves[host] = active
        if self.tracer.enabled:
            req.seated_s = time.perf_counter()
            self.tracer.event(
                "seat", lane=_request_lane(req.req_id), req_id=req.req_id,
                L=req.L, host=host, kind="solve", midchain=False)
        return active

    def _step_solve(self, host: int, group: GroupKey | None = None) -> int:
        """Advance the host's active solve by ``solve_iters_per_step`` CG
        iterations (seating the granted group's oldest queued solve first
        if none is active); retires it — mid-chain, its seat and queue
        budget free immediately — once the residual crosses tol or
        ``max_iters`` runs out, delivering the best iterate either way."""
        active = self._solves.get(host)
        if active is None:
            active = self._seat_solve(host, group)
            if active is None:
                return 0
        req, plan, state = active["req"], active["plan"], active["state"]
        if active["b_rs"] == 0.0:
            # zero right-hand side: x = 0 exactly; retire without iterating
            # (CG's alpha = <r,r>/<p,Ap> is 0/0 on this input)
            return self._retire_solve(host, active, state)
        if self.faults.enabled:
            f = self._dispatch_fault(host, "solve", "solve")
            if f is not None:
                # failed launch unseats the solve; a retry re-seats it fresh
                # (CG restarts are deterministic — same b, same schedule)
                del self._solves[host]
                quarantined = self.health.record_failure(host, "dispatch")
                self._retry_or_fail(req, "injected dispatch failure")
                if quarantined:
                    self._quarantine(host)
                return 0
        n = min(self.cfg.solve_iters_per_step,
                req.max_iters - state["iterations"])
        if (self._brownout is not None and self._brownout.rung >= 2
                and req.slo == SLO_BULK):
            # rung 2: bulk solves advance fewer CG iterations per turn,
            # returning turns to the latency lane sooner
            n = max(1, n // self.cfg.brownout.degrade_solve_factor)
            self.metrics.record_degraded_solve_turn()
        runner = active["runner"]
        shape_key = ("solve", req.L)
        cold = shape_key not in self._seen_shapes
        tr = self.tracer
        t0 = time.perf_counter()
        for _ in range(n):
            if tr.enabled:
                with tr.span("cg.iter", lane=host, req_id=req.req_id,
                             it=state["iterations"] + 1):
                    state = plan.cg_iterate(active["u_phys"], state)
                    _sync(state["rs"])
            else:
                state = plan.cg_iterate(active["u_phys"], state)
        if self.faults.enabled:
            # "kernel" seam for solves: poison the chunk's residual scalar —
            # the corrupted-iterate case the residual guard below must catch
            fk = self.faults.ask("kernel", host=host, kind="solve")
            if fk is not None:
                self.metrics.record_fault()
                if tr.enabled:
                    tr.event("chaos.fault", lane=host, site="kernel",
                             action=fk.action, seq=fk.seq, host=host,
                             kind="solve")
                state["rs"] = torch.full_like(state["rs"], float("nan"))
        if tr.enabled:
            with tr.span("cg.reduce", lane=host, req_id=req.req_id,
                         it=state["iterations"]):
                rs_host = float(state["rs"].item())
        else:
            rs_host = float(state["rs"].item())  # syncs the chunk
        step_s = time.perf_counter() - t0
        active["state"] = state
        if self.faults.enabled or self.cfg.numerics_guard:
            # CG residual guard: NaN/Inf or blow-up is numerical breakdown —
            # structured failure carrying the best iterate, never a hang
            bad = not math.isfinite(rs_host) or (
                rs_host > CG_DIVERGENCE_FACTOR * active["b_rs"])
            if bad:
                del self._solves[host]
                reason = ("non-finite residual" if not math.isfinite(rs_host)
                          else "diverged")
                quarantined = self.health.record_failure(host, f"cg {reason}")
                best = active["best"]
                residual = (rs_host / active["b_rs"]) ** 0.5 \
                    if math.isfinite(rs_host) else float("nan")
                terminal = CGDivergedError(
                    state["iterations"], residual, req.tol, reason=reason)
                # canonical best iterate rides along for the caller (same
                # shape the request's normal result would have had)
                terminal.partial = (
                    None if best is None else plan.unpack_vec(best[1]))
                self._retry_or_fail(req, f"cg {reason}", terminal=terminal)
                if quarantined:
                    self._quarantine(host)
                return 0
            self.health.record_success(host)
            best = active["best"]
            if best is None or rs_host < best[0]:
                active["best"] = (rs_host, state["x"])
        self._seen_shapes.add(shape_key)
        flops = float(CG_ITER_FLOPS_PER_SITE) * req.n_sites * n
        self.metrics.record_dispatch(
            live=1, padded=1, step_s=step_s, flops=flops, cold=cold, host=host,
        )
        self.metrics.record_iteration(host, kind="solve", n=n)
        if tr.enabled:
            self._trace_dispatch(
                runner, host, "solve", req.L, n, "solve", t0, step_s,
                live=1, padded=1, flops=flops, cold=cold)
        if rs_host <= active["stop2"] or state["iterations"] >= req.max_iters:
            return self._retire_solve(host, active, state)
        self.metrics.record_queue_depth(self.queued())
        return 0

    def _retire_solve(self, host: int, active: dict[str, Any],
                      state: dict[str, Any]) -> int:
        """Deliver the active solve's iterate and free its seat."""
        req, plan = active["req"], active["plan"]
        self._results[req.req_id] = plan.unpack_vec(state["x"])
        del self._solves[host]
        done_s = time.perf_counter()
        self.metrics.record_completion(
            done_s - req.arrival_s, tenant=req.tenant, slo=req.slo)
        if self.tracer.enabled:
            self._trace_request(req, done_s, host, "solve")
        self.metrics.record_queue_depth(self.queued())
        return 1

    def _step_continuous(self, host: int, group: GroupKey | None = None) -> int:
        """One iteration boundary for ``host``: admit the granted group's
        waiters, then advance each of its chains by one multiply."""
        batcher = self._batchers[host]
        self.metrics.record_iteration(host)
        slots = self._chain_slots()

        # 1) admission — existing chains first (mid-chain admits), then new
        #    chains for queued Ls that have none.  A request whose L differs
        #    from a chain's is never seated in it (InflightChain.admit
        #    enforces the shape incompatibility); it reaches its own chain
        #    here.
        for L in batcher.queued_Ls(group):
            chain_key = (host, L)
            if chain_key not in self._chains:
                runner = self.runner_for(L, host)
                self._chains[chain_key] = (
                    InflightChain(L=L, slots=slots),
                    _ChainArrays(runner, slots),
                )
            chain, arrays = self._chains[chain_key]
            free = slots - chain.live
            if not free and group is not None and group[1] == SLO_LATENCY:
                # a full chain never blocks the latency lane: the youngest
                # bulk seat is preempted (re-queued) to admit this turn
                if self._preempt_bulk(
                        chain.occupants(),
                        lambda s, c=chain, a=arrays: (c.evict(s), a.clear(s)),
                        host):
                    free = 1
            if not free:
                continue
            admitted = batcher.next_for_L(L, free, group=group)
            for req in admitted:
                slot = chain.admit(req)
                arrays.seat(slot, req.a, req.b)
                if self.tracer.enabled:
                    req.seated_s = time.perf_counter()
                    self.tracer.event(
                        "seat", lane=_request_lane(req.req_id),
                        req_id=req.req_id, slot=slot, L=L, host=host,
                        midchain=chain.midchain)
            if admitted and chain.midchain:
                self.metrics.record_midchain_admits(len(admitted))

        # 2) advance every live chain of this host by ONE iteration
        completed = 0
        queued_Ls = set(batcher.queued_Ls())
        for (h, L) in [key for key in self._chains if key[0] == host]:
            chain, arrays = self._chains[(h, L)]
            if not chain.live:
                if L not in queued_Ls:
                    # dead chain with nothing queued: drop it (its shape
                    # key stays in _seen_shapes)
                    del self._chains[(h, L)]
                continue
            runner = arrays.runner
            n_sites = L**4
            if self.faults.enabled:
                f = self._dispatch_fault(host, "multiply", "continuous")
                if f is not None:
                    quarantined = self.health.record_failure(host, "dispatch")
                    self._charge_seated(
                        chain.occupants(),
                        lambda s, c=chain, a=arrays: (c.evict(s), a.clear(s)),
                        "injected dispatch failure")
                    if quarantined:
                        self._quarantine(host)
                        return completed  # this host's chains are gone
                    continue  # seated survivors re-dispatch next turn
            shape_key = self._shape_key(runner, L, 1, slots)
            cold = shape_key not in self._seen_shapes
            live = chain.live
            t0 = time.perf_counter()
            prev_a = arrays.a_parts  # advance() writes a new table
            arrays.advance()
            if self.faults.enabled:
                arrays.a_parts = self._poison_output(
                    arrays.a_parts, host, "multiply")
            _sync(arrays.a_parts)
            step_s = time.perf_counter() - t0
            if (self.faults.enabled or self.cfg.numerics_guard) \
                    and not self._finite(arrays.a_parts):
                # roll the chain state back: the retried advance re-runs
                # from the same iterate, bitwise clean
                arrays.a_parts = prev_a
                quarantined = self.health.record_failure(
                    host, "non-finite output")
                self._charge_seated(
                    chain.occupants(),
                    lambda s, c=chain, a=arrays: (c.evict(s), a.clear(s)),
                    "non-finite kernel output")
                if quarantined:
                    self._quarantine(host)
                    return completed
                continue
            if self.faults.enabled or self.cfg.numerics_guard:
                self.health.record_success(host)
            self._seen_shapes.add(shape_key)
            self.metrics.record_dispatch(
                live=live, padded=slots, step_s=step_s,
                flops=request_flops(n_sites, 1) * live, cold=cold, host=host,
            )
            if self.tracer.enabled:
                self._trace_dispatch(
                    runner, host, "multiply", L, 1, "continuous", t0, step_s,
                    live=live, padded=slots,
                    flops=request_flops(n_sites, 1) * live, cold=cold)
            done_s = time.perf_counter()
            for slot, req in chain.advance():
                self._results[req.req_id] = arrays.result(slot, n_sites)
                arrays.clear(slot)
                self.metrics.record_completion(
                    done_s - req.arrival_s, tenant=req.tenant, slo=req.slo)
                if self.tracer.enabled:
                    self._trace_request(req, done_s, host, "continuous")
                completed += 1
        self.metrics.record_queue_depth(self.queued())
        return completed

    # -- megakernel dispatch (one batched K-chain call per host) --------------

    def _table_for(self, host: int, cap_L: int) -> tuple[SlotTable, _SlotTableArrays]:
        """The host's slot table, built (or capacity-grown) for ``cap_L``.

        Growing re-seats every live slot's *current* mid-chain lattice into
        the larger-capacity arrays at the same slot index — the scheduling
        half (SlotTable) is untouched, so remaining counts and admission
        bookkeeping survive the grow.
        """
        slots = self._chain_slots()
        entry = self._tables.get(host)
        if entry is not None and cap_L <= entry[1].cap_L:
            return entry
        runner = self.runner_for(cap_L, host)
        arrays = _SlotTableArrays(runner, slots, max_k=self.cfg.chain_horizon,
                                  in_place=not self._guarded)
        if entry is None:
            self._tables[host] = (SlotTable(slots), arrays)
        else:
            table, old = entry
            for slot, req, _remaining in table.occupants():
                a_mid = old.result(slot, req.n_sites)  # mid-chain state
                arrays.seat(slot, a_mid, req.b)
            self._tables[host] = (table, arrays)
        return self._tables[host]

    def _step_megakernel(self, host: int, group: GroupKey | None = None) -> int:
        """One iteration boundary for ``host``: slot-swap admission across
        the granted group's queued lattice sizes, then ONE batched K-chain
        dispatch."""
        batcher = self._batchers[host]
        self.metrics.record_iteration(host)
        queued = batcher.queued_Ls(group)
        entry = self._tables.get(host)
        if entry is None and not queued:
            return 0

        # 1) admission — a slot swap per request, any L (grow capacity first
        #    so every queued size fits the one dispatched shape)
        if queued:
            cap_L = max(queued + ([entry[1].cap_L] if entry else []))
            table, arrays = self._table_for(host, cap_L)
            for L in queued:
                free = self._chain_slots() - table.live
                if not free and group is not None \
                        and group[1] == SLO_LATENCY:
                    # full table: preempt the youngest bulk seat so the
                    # latency lane admits this turn
                    if self._preempt_bulk(
                            table.occupants(),
                            lambda s, t=table, a=arrays: (
                                t.evict(s), a.clear(s)),
                            host):
                        free = 1
                if not free:
                    break
                admitted = batcher.next_for_L(L, free, group=group)
                for req in admitted:
                    slot = table.admit(req)
                    arrays.seat(slot, req.a, req.b)
                    if self.tracer.enabled:
                        req.seated_s = time.perf_counter()
                        self.tracer.event(
                            "seat", lane=_request_lane(req.req_id),
                            req_id=req.req_id, slot=slot, L=L, host=host,
                            midchain=table.midchain)
                if admitted and table.midchain:
                    self.metrics.record_midchain_admits(len(admitted))
        table, arrays = self._tables[host]

        # 2) ONE megakernel dispatch advancing every live slot by its own
        #    scheduled depth (min(remaining, horizon))
        completed = 0
        ks = table.plan_k(self.cfg.chain_horizon)
        if any(ks):
            occupants = table.occupants()
            degraded = False
            quarantine_pending = False
            if self.faults.enabled:
                f = self._dispatch_fault(host, "multiply", "megakernel")
                if f is not None:
                    # degradation ladder: the failed megakernel batch
                    # re-dispatches down the per-(L) chained path this turn
                    # (one runner.multiply per live slot); repeated failures
                    # still walk the host toward quarantine
                    degraded = True
                    self.metrics.record_degraded()
                    quarantine_pending = self.health.record_failure(
                        host, "dispatch")
            shape_key = ("mega", arrays.cap_L, table.slots, self.cfg.chain_horizon)
            cold = shape_key not in self._seen_shapes
            live = table.live
            t0 = time.perf_counter()
            # with a fault plan or the guard armed the table is written out
            # of place (in_place=False), so prev_a survives the launch
            prev_a = arrays.a_parts
            if degraded:
                for slot, req, _rem in occupants:
                    if not ks[slot]:
                        continue
                    a_mid = arrays.result(slot, req.n_sites)
                    c = self.runner_for(req.L, host).multiply(
                        a_mid[None], req.b[None], k=ks[slot])[0]
                    arrays.seat(slot, c, req.b)
            else:
                arrays.advance(ks)
                if self.faults.enabled:
                    arrays.a_parts = self._poison_output(
                        arrays.a_parts, host, "multiply")
            _sync(arrays.a_parts)
            step_s = time.perf_counter() - t0
            if not degraded and (self.faults.enabled or self.cfg.numerics_guard) \
                    and not self._finite(arrays.a_parts):
                arrays.a_parts = prev_a  # retried advance is bitwise clean
                quarantined = self.health.record_failure(
                    host, "non-finite output")
                self._charge_seated(
                    table.occupants(),
                    lambda s, t=table, a=arrays: (t.evict(s), a.clear(s)),
                    "non-finite kernel output")
                if quarantined:
                    self._quarantine(host)
                else:
                    self.metrics.record_queue_depth(self.queued())
                return 0
            if not degraded and (self.faults.enabled or self.cfg.numerics_guard):
                self.health.record_success(host)
            self._seen_shapes.add(shape_key)
            dispatch_flops = sum(
                request_flops(req.n_sites, ks[slot])
                for slot, req, _rem in occupants
            )
            self.metrics.record_dispatch(
                live=live, padded=table.slots, step_s=step_s,
                flops=dispatch_flops,
                cold=cold, host=host,
            )
            if self.tracer.enabled:
                self._trace_dispatch(
                    arrays.runner, host, "multiply", arrays.cap_L,
                    self.cfg.chain_horizon, "megakernel", t0, step_s,
                    live=live, padded=table.slots, flops=dispatch_flops,
                    cold=cold)
            done_s = time.perf_counter()
            for slot, req in table.advance(ks):
                self._results[req.req_id] = arrays.result(slot, req.n_sites)
                arrays.clear(slot)
                self.metrics.record_completion(
                    done_s - req.arrival_s, tenant=req.tenant, slo=req.slo)
                if self.tracer.enabled:
                    self._trace_request(req, done_s, host, "megakernel")
                completed += 1
            if quarantine_pending:
                # crossed the consecutive-failure latch this turn: deliver
                # the degraded batch's completions above, then re-seat the
                # survivors onto healthy hosts
                self._quarantine(host)
        self.metrics.record_queue_depth(self.queued())
        return completed

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        """Step until queues, retry backoffs AND in-flight chains empty;
        returns completed."""
        total = 0
        for _ in range(max_steps):
            if not self._work_pending():
                return total
            n = self.step()
            total += n
            if n == 0 and self._retry_q and not self._solves \
                    and not any(len(b) for b in self._batchers):
                # only backoff waits remain: sleep to the earliest eligible
                # retry instead of spinning max_steps away
                nxt = min(t for t, _ in self._retry_q)
                time.sleep(max(0.0, min(nxt - time.perf_counter(), 0.01)))
        raise RuntimeError(f"queue not drained after {max_steps} steps")

    # -- results -------------------------------------------------------------

    def has_result(self, req_id: int) -> bool:
        return req_id in self._results

    def pop_result(self, req_id: int) -> Any:
        """The canonical complex result for a completed request (once) — or
        the structured failure object (:class:`RequestFailure` subclass, or
        a ``CGDivergedError``) the request resolved with; check
        ``isinstance(out, Exception)``.  ``arun`` raises these instead."""
        return self._results.pop(req_id)

    def pop_ready(self) -> dict[int, Any]:
        """All completed results, cleared from the service (delivery drain).

        A caller that steps the service itself (replay harnesses, pollers)
        must drain results this way or via ``pop_result`` — undelivered C
        lattices are device tensors and accumulate for the service lifetime.
        Results owned by a pending :meth:`arun` coroutine are left in place;
        only that coroutine delivers them.
        """
        if not self._awaited:
            out, self._results = self._results, {}
            return out
        out = {rid: c for rid, c in self._results.items() if rid not in self._awaited}
        for rid in out:
            del self._results[rid]
        return out

    # -- asyncio face --------------------------------------------------------

    async def arun(self, a: torch.Tensor, b: torch.Tensor, k: int | None = None,
                   deadline_s: float | None = None,
                   tenant: str = DEFAULT_TENANT,
                   slo: str | None = None) -> torch.Tensor:
        """Submit and await one request from an asyncio front-end.

        Concurrent ``arun`` coroutines submitted in the same scheduler tick
        coalesce into one dispatch — whichever coroutine steps first serves
        the whole bucket.  Backpressure surfaces as cooperative retry with
        CAPPED EXPONENTIAL BACKOFF: the first rejection yields to the loop
        (letting other coroutines drain the queue) and retries immediately;
        sustained rejection sleeps the retry policy's jittered, capped
        schedule instead of pegging the event loop with submit attempts.
        Quota backpressure (a dry tenant bucket) rides the same loop — the
        coroutine backs off until the bucket refills.  A request that
        resolves with a structured failure (deadline, shed, brownout,
        retries exhausted, CG divergence) RAISES it here.
        """
        req_id = self.submit(a, b, k, deadline_s=deadline_s,
                             tenant=tenant, slo=slo)
        attempt = 0
        while req_id is None:
            if attempt == 0:
                await asyncio.sleep(0)  # same-tick coalescing fast path
            else:
                await asyncio.sleep(
                    self.cfg.retry.backoff_s(attempt, self._retry_rng))
            attempt += 1
            self.step()
            req_id = self.submit(a, b, k, deadline_s=deadline_s,
                                 tenant=tenant, slo=slo)
        self._awaited.add(req_id)  # shield from a concurrent pop_ready drain
        try:
            while not self.has_result(req_id):
                await asyncio.sleep(0)
                self.step()
            out = self.pop_result(req_id)
            if isinstance(out, Exception):
                raise out
            return out
        finally:
            self._awaited.discard(req_id)
