"""repro_torch.serve.su3 — dynamic-batching SU3 lattice serving on one card.

Public surface:

  ServiceConfig / SU3Service   the traffic-handling front door over the
                               warm ExecutionPlan pool (bf16-storage plans
                               via dtype="bfloat16", accum_dtype="float32")
  BatcherConfig / DynamicBatcher / ServeRequest / CoalescedBatch
                               the (L, k)-bucketed coalescing queue
  LocalityRouter / InflightChain
                               host-locality routing and continuous-batching
                               chain admission (multi-host serving)
  ServiceMetrics               latency/throughput/occupancy accounting
  RequestFailure taxonomy      structured per-request failures delivered
                               through the result channel (DeadlineExceeded
                               / RetriesExhausted / LoadShed), plus the
                               RetryPolicy / HostHealth robustness knobs
  tenancy layer                SLO classes (latency/bulk) + SLOPolicy,
                               per-tenant TenantQuota token buckets, the
                               DeficitFairScheduler over (tenant, class)
                               groups, WarmPoolAutoscaler, and the
                               three-rung BrownoutLadder overload control
"""
from repro_torch.serve.su3.batcher import (
    BatcherConfig,
    CoalescedBatch,
    DynamicBatcher,
    InflightChain,
    LocalityRouter,
    ServeRequest,
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
from repro_torch.serve.su3.service import ServiceConfig, SU3Service
from repro_torch.serve.su3.tenancy import (
    DEFAULT_TENANT,
    SLO_BULK,
    SLO_CLASSES,
    SLO_LATENCY,
    AutoscaleConfig,
    BrownoutConfig,
    BrownoutLadder,
    DeficitFairScheduler,
    SLOPolicy,
    TenantQuota,
    TokenBucket,
    WarmPoolAutoscaler,
)

__all__ = [
    "AutoscaleConfig",
    "BatcherConfig",
    "BrownoutConfig",
    "BrownoutLadder",
    "CoalescedBatch",
    "DEFAULT_TENANT",
    "DeadlineExceededError",
    "DeficitFairScheduler",
    "DynamicBatcher",
    "HostHealth",
    "InflightChain",
    "LoadShedError",
    "LocalityRouter",
    "PRIORITY",
    "RequestFailure",
    "RetriesExhaustedError",
    "RetryPolicy",
    "SLOPolicy",
    "SLO_BULK",
    "SLO_CLASSES",
    "SLO_LATENCY",
    "ServeRequest",
    "ServiceMetrics",
    "ServiceConfig",
    "SU3Service",
    "TenantQuota",
    "TokenBucket",
    "WarmPoolAutoscaler",
    "request_flops",
]
