"""repro_torch.chaos — deterministic, seeded fault injection for the serving stack.

The paper's lesson is that SU3_Bench's peak is *fragile*: init placement,
NUMA, and pipeline-throughput subtleties degrade silently instead of
failing loudly.  A production serving stack needs the failure modes made
explicit and survivable — and testable on demand.  This module is the
"on demand" half: a :class:`FaultPlan` draws from per-site seeded RNG
streams and decides, at each of four real seams, whether that call fails
and how:

  ``dispatch``   a host's (mega)kernel launch fails or is delayed —
                 the slow/failed-rank case every multi-node lattice stack
                 hits (one stalled rank stalls the solve);
  ``halo``       a ghost slab of the stencil exchange is dropped (zeros)
                 or corrupted (NaN) before the boundary pass consumes it
                 (a multi-slab plan's overlapped stencil asks it after
                 every exchange; :func:`corrupt_ghosts` applies it);
  ``kernel``     a kernel's output is poisoned with NaN/Inf — the silent
                 numerical corruption the CG residual guards must catch;
  ``pool``       warm-pool runner construction fails (the cold-build seam:
                 a host that cannot compile/allocate its plan).

Determinism contract: each site draws from its OWN ``random.Random``
stream seeded by ``(seed, site)``, so a site's fire/no-fire schedule
depends only on how many times *that site* was asked — not on how asks
interleave across sites.  The same seed over the same request schedule
reproduces the same fault sequence exactly (``log()`` equality is the
test), which is what makes a chaos failure a *bug report* instead of a
shrug.

Cost contract: the disabled plan (:data:`NULL_FAULT_PLAN`) is the default
everywhere; every injection point is one ``if faults.enabled`` branch
(same guard style as ``tracer.enabled``), so the fault-free hot path
allocates nothing and the fault-free results stay bitwise identical to a
build without this module.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any

SITES = ("dispatch", "halo", "kernel", "pool")

# action vocabulary per site (the first action is the default)
SITE_ACTIONS = {
    "dispatch": ("fail", "delay"),
    "halo": ("drop", "corrupt"),
    "kernel": ("nan", "inf"),
    "pool": ("fail",),
}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fired injection: what happened, where, and in what order."""

    site: str
    action: str
    seq: int  # global fire sequence number (0-based, across sites)
    site_seq: int  # how many times this site had been asked when it fired
    delay_s: float = 0.0  # "delay" action: injected stall seconds
    ctx: tuple = ()  # sorted (key, value) call-site context, hashable

    def as_dict(self) -> dict[str, Any]:
        return {
            "site": self.site, "action": self.action, "seq": self.seq,
            "site_seq": self.site_seq, "delay_s": self.delay_s,
            "ctx": dict(self.ctx),
        }


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-site schedule: when and how one injection point fires.

    Attributes:
        probability: per-ask fire probability from the site's seeded stream.
        actions: actions drawn (uniformly, same stream) when firing; must be
            a subset of :data:`SITE_ACTIONS` for the site.
        delay_s: stall injected by the ``delay`` action.
        after: never fire for the first ``after`` asks (lets warmup and
            compile paths run clean so a storm hits steady state).
        max_fires: stop firing after this many (``-1`` = unbounded) — a
            storm that ends, so recovery is observable.
    """

    probability: float = 0.0
    actions: tuple[str, ...] = ()
    delay_s: float = 0.005
    after: int = 0
    max_fires: int = -1

    def __post_init__(self) -> None:
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {self.probability}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")

    def describe(self) -> dict[str, Any]:
        return {
            "probability": self.probability, "actions": list(self.actions),
            "delay_s": self.delay_s, "after": self.after,
            "max_fires": self.max_fires,
        }


class FaultPlan:
    """Seeded, per-site fault schedule with a complete fire log.

    Args:
        seed: the reproduction handle — the same seed over the same ask
            schedule fires the same faults in the same order.
        sites: ``{site: FaultSpec}``; unknown sites are rejected, missing
            sites never fire.  Actions default to the site's first
            vocabulary entry.
        enabled: ``False`` builds a dead plan (every ``ask`` returns None
            without drawing); :data:`NULL_FAULT_PLAN` is the shared one.
    """

    def __init__(self, seed: int = 0, sites: dict[str, FaultSpec] | None = None,
                 enabled: bool = True):
        sites = dict(sites or {})
        for site, spec in sites.items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; known: {SITES}")
            bad = set(spec.actions) - set(SITE_ACTIONS[site])
            if bad:
                raise ValueError(
                    f"site {site!r} does not support actions {sorted(bad)}; "
                    f"supported: {SITE_ACTIONS[site]}"
                )
        self.seed = int(seed)
        self.specs = sites
        self.enabled = bool(enabled) and any(
            s.probability > 0 for s in sites.values()
        )
        self._rngs = {
            site: random.Random(f"{self.seed}:{site}") for site in sites
        }
        self._asked = {site: 0 for site in sites}
        self._fired_per_site = {site: 0 for site in sites}
        self._log: list[Fault] = []

    # ------------------------------------------------------------------ fire
    def ask(self, site: str, **ctx: Any) -> Fault | None:
        """One injection-point consultation; returns the Fault to apply or
        None.  Callers guard with ``if faults.enabled`` so the disabled
        path never packs ``ctx``."""
        spec = self.specs.get(site)
        if not self.enabled or spec is None or spec.probability <= 0.0:
            return None
        rng = self._rngs[site]
        site_seq = self._asked[site]
        self._asked[site] = site_seq + 1
        # one draw per ask keeps the site stream aligned with the ask count
        u = rng.random()
        if site_seq < spec.after:
            return None
        if spec.max_fires >= 0 and self._fired_per_site[site] >= spec.max_fires:
            return None
        if u >= spec.probability:
            return None
        actions = spec.actions or (SITE_ACTIONS[site][0],)
        action = actions[rng.randrange(len(actions))] if len(actions) > 1 else actions[0]
        fault = Fault(
            site=site, action=action, seq=len(self._log), site_seq=site_seq,
            delay_s=spec.delay_s if action == "delay" else 0.0,
            ctx=tuple(sorted(ctx.items())),
        )
        self._fired_per_site[site] += 1
        self._log.append(fault)
        return fault

    # ------------------------------------------------------------------ read
    def log(self) -> list[dict[str, Any]]:
        """Every fired fault, in fire order — the reproduction record two
        same-seed runs must agree on."""
        return [f.as_dict() for f in self._log]

    @property
    def fired(self) -> int:
        return len(self._log)

    def fired_by_site(self) -> dict[str, int]:
        return {s: n for s, n in sorted(self._fired_per_site.items()) if n}

    def describe(self) -> dict[str, Any]:
        """The provenance block: seed + per-site schedule (what to stamp
        next to any result produced under this plan)."""
        return {
            "seed": self.seed,
            "sites": {s: spec.describe() for s, spec in sorted(self.specs.items())},
        }

    def reset(self) -> "FaultPlan":
        """A fresh plan with the identical schedule (same seed, same specs)
        — the second run of a reproduction pair."""
        return FaultPlan(self.seed, self.specs, enabled=True)


NULL_FAULT_PLAN = FaultPlan(enabled=False)


def storm(seed: int = 0, *, dispatch_p: float = 0.0, halo_p: float = 0.0,
          kernel_p: float = 0.0, pool_p: float = 0.0, after: int = 0,
          max_fires: int = -1, delay_s: float = 0.005) -> FaultPlan:
    """Convenience builder: one probability per site, all actions enabled."""
    sites = {}
    for site, p in (("dispatch", dispatch_p), ("halo", halo_p),
                    ("kernel", kernel_p), ("pool", pool_p)):
        if p > 0:
            sites[site] = FaultSpec(
                probability=p, actions=SITE_ACTIONS[site], delay_s=delay_s,
                after=after, max_fires=max_fires,
            )
    return FaultPlan(seed, sites)


def poison_array(x, action: str):
    """Apply a ``kernel``-site fault to a tensor: a NEW tensor equal to ``x``
    with its first element NaN ("nan") or Inf ("inf").  ``x`` itself is
    never written, so a caller that kept it can roll back to it.
    Deterministic — the poison lands at a fixed position so a retried clean
    dispatch is bitwise comparable."""
    bad = float("nan") if action == "nan" else float("inf")
    out = x.flatten().clone()
    out[0] = bad
    return out.view(x.shape)


def corrupt_ghosts(ghosts: tuple, action: str) -> tuple:
    """Apply a ``halo``-site fault to an exchanged ghost tuple: "drop"
    zeroes every tensor (a lost message), "corrupt" fills it with NaN (a
    mangled one).  New tensors; the exchanged ones are left as they were."""
    import torch

    if action == "drop":
        return tuple(torch.zeros_like(g) for g in ghosts)
    return tuple(torch.full_like(g, float("nan")) for g in ghosts)
