"""Bounded streaming statistics for long-running services.

ServiceMetrics used to append every latency/occupancy/queue-depth sample to
a Python list — unbounded growth over a service lifetime.  These two
primitives replace the lists while keeping small-sample semantics *exact*
(below capacity the reservoir holds every sample, so the pinned snapshot
tests — 3 completions, exact p50 — see identical numbers):

  Reservoir     Vitter's algorithm-R reservoir over a fixed capacity with
                a deterministic RNG (seeded per-instance: no test flake),
                plus running count/sum so ``mean`` stays exact even after
                eviction starts.
  RunningStat   O(1) count/sum/min/max — for series only ever consumed as
                mean/max (occupancies, queue depths).
"""
from __future__ import annotations

import random

import numpy as np


class Reservoir:
    """Fixed-capacity uniform sample of a stream; exact below capacity."""

    __slots__ = ("capacity", "count", "total", "_sample", "_rng")

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError("Reservoir capacity must be >= 1")
        self.capacity = int(capacity)
        self.count = 0
        self.total = 0.0
        self._sample: list[float] = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if len(self._sample) < self.capacity:
            self._sample.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._sample[j] = value

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def sample(self) -> list[float]:
        return list(self._sample)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not self._sample:
            return 0.0
        return float(np.percentile(self._sample, q))


class RunningStat:
    """Count/sum/min/max without retaining samples."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def max_or(self, default: float = 0.0) -> float:
        return self.max if self.count else default
