"""Fault tolerance + elasticity (port of
``repro.distributed.fault_tolerance``; plain Python and numpy, as there).

Each mechanism is written against host names and device counts, so the
logic is unit-testable on one machine:

  * HeartbeatMonitor — per-host liveness with EWMA step-time tracking;
    flags dead hosts (missed deadline) and stragglers (step time > k x
    fleet median, the paper's "slowest UPI path" analog at fleet scale).
  * ElasticMeshPlanner — given surviving hosts, picks the largest
    (data, model)-factorable mesh <= survivors, preferring to shrink the
    *data* axis (pure-DP slices are stateless beyond the data shard; the
    model axis is rebuilt only when a model-shard host dies).

The training loop drives one monitor for its one host.  The restart
recipe (the planner's new mesh, the checkpoint restored onto it, the
pipeline resumed from its step) is ``launch/train.py --restart-from DIR
--alive ... --dead ...``: ``ElasticMeshPlanner.plan`` gives the (data,
model) shape, ``launch.mesh.make_mesh`` builds it over the ranks left, and
``train.loop.train(mesh=..., restore_dir=DIR)`` restores and trains on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class HostState:
    last_seen: float
    step_time_ewma: float = 0.0


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], *, deadline_s: float = 60.0,
                 straggler_factor: float = 2.0, ewma: float = 0.9):
        self.deadline_s = deadline_s
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        now = time.monotonic()
        self.hosts: dict[str, HostState] = {h: HostState(last_seen=now) for h in hosts}

    def beat(self, host: str, step_time_s: float | None = None, *, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        st = self.hosts.setdefault(host, HostState(last_seen=now))
        st.last_seen = now
        if step_time_s is not None:
            st.step_time_ewma = (
                step_time_s if st.step_time_ewma == 0.0
                else self.ewma * st.step_time_ewma + (1 - self.ewma) * step_time_s
            )

    def dead(self, *, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, s in self.hosts.items() if now - s.last_seen > self.deadline_s]

    def stragglers(self) -> list[str]:
        times = [s.step_time_ewma for s in self.hosts.values() if s.step_time_ewma > 0]
        if len(times) < 2:
            return []
        med = float(np.median(times))
        return [
            h for h, s in self.hosts.items()
            if s.step_time_ewma > self.straggler_factor * med
        ]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    dropped_hosts: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return self.data * self.model


class ElasticMeshPlanner:
    """Choose the next mesh after failures.

    Invariants: model axis preserved if possible (model-sharded state is
    expensive to reshard); data axis shrinks to the largest count that
    divides the global batch (so per-shard batch stays integral).
    """

    def __init__(self, *, devices_per_host: int, model_axis: int, global_batch: int):
        self.devices_per_host = devices_per_host
        self.model_axis = model_axis
        self.global_batch = global_batch

    def plan(self, alive_hosts: Sequence[str], dead_hosts: Sequence[str]) -> MeshPlan:
        n_devices = len(alive_hosts) * self.devices_per_host
        model = self.model_axis
        while model > 1 and n_devices % model:
            model //= 2
        data = n_devices // model
        # shrink data until it divides the global batch
        while data > 1 and self.global_batch % data:
            data -= 1
        return MeshPlan(data=data, model=model, dropped_hosts=tuple(dead_hosts))


def straggler_safe_step_budget(step_times_s: Sequence[float], factor: float = 2.0) -> float:
    """Deadline for collective participation before a host is suspected."""
    if not step_times_s:
        return float("inf")
    return factor * float(np.median(np.asarray(step_times_s)))
