"""repro_torch.chaos — seeded fault injection (see :mod:`repro_torch.chaos.faults`).

``FaultPlan`` decides, deterministically per seed, whether each consulted
seam (host dispatch, stencil halo, kernel output, warm-pool build) fails
and how; ``NULL_FAULT_PLAN`` is the shared disabled instance every hot path
defaults to (one ``if faults.enabled`` branch, zero cost).
"""
from repro_torch.chaos.faults import (
    NULL_FAULT_PLAN,
    SITE_ACTIONS,
    SITES,
    Fault,
    FaultPlan,
    FaultSpec,
    corrupt_ghosts,
    poison_array,
    storm,
)

__all__ = [
    "NULL_FAULT_PLAN",
    "SITE_ACTIONS",
    "SITES",
    "Fault",
    "FaultPlan",
    "FaultSpec",
    "corrupt_ghosts",
    "poison_array",
    "storm",
]
