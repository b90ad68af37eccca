"""SU3 benchmark engine: timed multiply loop + validation over an
ExecutionPlan (port of ``repro.core.su3.engine``).

``SU3Engine`` owns the measurement protocol of the su3_bench driver:
W warmup + I timed iterations of ``C = A (x) B``, reporting GF/s (useful
flops = 864/site) and GB/s (layout traffic model), and on a known card the
roofline bound and the share of it reached.

  ``run()``        I separately launched single steps, each timed.
  ``run_fused(k)`` one launch chaining k multiplies; per-multiply seconds
                   are reported so the two modes compare directly.

On the card each timed launch sits between a pair of ``torch.cuda.Event``
records; on the CPU the host clock times it.  On a ranked plan (its slabs
over a process group) the timed window opens and closes at a barrier,
each iteration counts at the slowest rank's time, GB/s is the whole
lattice's, and the row gives the world size and every rank's init
seconds.  Validation follows su3_bench:
with A entries = (1,0) and B entries = (1/3,0) every element of C is (1,0),
a fixed point of the multiply, so chained steps validate identically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import roofline
from repro_torch.core.su3.layouts import GaugeCompression, Layout, TrafficModel
from repro_torch.core.su3.plan import EngineConfig, ExecutionPlan, build_plan  # noqa: F401
from repro_torch.launch.mesh import MeshSpec, SlabMesh


@dataclasses.dataclass
class BenchResult:
    config: EngineConfig
    n_devices: int
    init_seconds: float
    scatter_seconds: float  # host_scatter copy cost (0 otherwise)
    iter_seconds: list[float]  # per-multiply seconds (fused runs pre-divide by k)
    verified: bool
    fused_k: int = 1  # multiplies chained per launch (1 = classic loop)
    plan_id: str = ""
    device: str = "cpu"  # torch.cuda.get_device_name() on the card
    world: int = 1  # ranks the plan's slabs are spread over
    rank_init_seconds: list[float] | None = None  # every rank's, on a ranked plan

    @property
    def best_seconds(self) -> float:
        return min(self.iter_seconds)

    @property
    def mean_seconds(self) -> float:
        return float(np.mean(self.iter_seconds))

    @property
    def traffic(self) -> TrafficModel:
        return TrafficModel(
            self.config.layout,
            self.config.shape.n_sites,
            self.config.word_bytes,
            compression=GaugeCompression(self.config.compression),
        )

    @property
    def gflops(self) -> float:
        """Useful GF/s, the paper's reported figure (864 flops/site)."""
        return self.traffic.flops_per_site * self.config.shape.n_sites / self.best_seconds / 1e9

    @property
    def gbytes(self) -> float:
        """Effective GB/s from the layout traffic model (paper's GBYTES column)."""
        return self.traffic.total_bytes / self.best_seconds / 1e9

    @property
    def bound_seconds(self) -> float | None:
        """Least per-multiply seconds the card allows (a k-chain moves its
        bytes once for k multiplies); None off a known card."""
        hw = roofline.hardware_for_device(self.device)
        if hw is None:
            return None
        report = roofline.analytic_su3_report(
            n_sites=self.config.shape.n_sites,
            bytes_per_site_rw=self.traffic.bytes_per_site_rw,
            k=self.fused_k,
            hw=hw,
        )
        return report.bound_s / self.fused_k

    @property
    def bound_share(self) -> float | None:
        """bound / best measured seconds: 1.0 is the roofline."""
        bound = self.bound_seconds
        return None if bound is None else bound / self.best_seconds

    def row(self) -> dict[str, Any]:
        return {
            "L": self.config.L,
            "layout": Layout(self.config.layout).value,
            "variant": self.config.variant,
            "placement": self.config.placement,
            "dtype": self.config.dtype,
            "compression": self.config.compression,
            "devices": self.n_devices,
            "GFLOPS": round(self.gflops, 3),
            "GBYTES": round(self.gbytes, 3),
            "bytes_per_site": self.traffic.bytes_per_site_rw,
            "best_s": self.best_seconds,
            "mean_s": self.mean_seconds,
            "init_s": self.init_seconds,
            "scatter_s": self.scatter_seconds,
            "verified": self.verified,
            "fused_k": self.fused_k,
            "plan": self.plan_id,
            "device": self.device,
            "bound_s": self.bound_seconds,
            "bound_share": self.bound_share,
        } | ({} if self.rank_init_seconds is None else
             {"world": self.world, "rank_init_s": self.rank_init_seconds})


class _LaunchTimer:
    """Seconds of enqueued work: CUDA event pairs on the card (read after one
    synchronize), the host clock around blocking work on the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._host: list[float] = []

    def __call__(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._events.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self._host.append(time.perf_counter() - t0)
        return out

    def seconds(self) -> list[float]:
        if not self._cuda:
            return list(self._host)
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for s, e in self._events]


class SU3Engine:
    """Paper-faithful benchmark runner over an ExecutionPlan on one device
    (``None`` = the CUDA device; ``"cpu"`` runs the plain versions) or on a
    mesh (a ``MeshSpec`` or ``SlabMesh``: on ranks when a process group
    runs)."""

    def __init__(self, cfg: EngineConfig,
                 device: MeshSpec | SlabMesh | torch.device | str | None = None):
        self.plan = build_plan(cfg, device)
        self.cfg = cfg
        self.device = self.plan.device
        self.n_devices = self.plan.n_devices
        self.padded = self.plan.padded_sites
        self._step = self.plan.step

    def init_data(self) -> tuple[torch.Tensor, torch.Tensor, float, float]:
        return self.plan.init_data()

    def verify(self, c_phys: torch.Tensor) -> bool:
        return self.plan.verify(c_phys)

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def _window(self) -> None:
        """On ranks: every rank's queued work done, then a barrier (the
        timed window's edges)."""
        if self.plan.is_ranked:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            torch.distributed.barrier(group=self.plan.group)

    def _slowest(self, times: list[float]) -> list[float]:
        """Each iteration's seconds at the slowest rank (as given off ranks)."""
        if not self.plan.is_ranked:
            return times
        t = torch.tensor(times, dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.plan.group)
        return t.tolist()

    def _result(self, init_s, scatter_s, times, verified, fused_k=1) -> BenchResult:
        ranks = None
        if self.plan.is_ranked:
            mine = torch.tensor([init_s], dtype=torch.float64, device=self.device)
            ranks = [float(x) for x in self.plan.gather_ranks(mine)]
        return BenchResult(
            config=self.cfg,
            n_devices=self.n_devices,
            init_seconds=init_s,
            scatter_seconds=scatter_s,
            iter_seconds=times,
            verified=verified,
            fused_k=fused_k,
            plan_id=self.plan.describe(),
            device=self._device_name(),
            world=self.plan.world,
            rank_init_seconds=ranks,
        )

    def run(self) -> BenchResult:
        """W warmups + I timed single-step launches (the paper's loop);
        A is reused by every step, each writes a fresh C."""
        cfg = self.cfg
        a_phys, b_p, init_s, scatter_s = self.init_data()
        c_phys = a_phys
        for _ in range(cfg.warmups):
            c_phys = self._step(a_phys, b_p)
        timer = _LaunchTimer(self.device)
        self._window()
        for _ in range(cfg.iterations):
            c_phys = timer(lambda: self._step(a_phys, b_p))
        times = timer.seconds()
        self._window()
        times = self._slowest(times)
        verified = self.verify(c_phys)
        return self._result(init_s, scatter_s, times, verified)

    def compare_fused(self, k: int, reps: int = 10) -> dict[str, Any]:
        """Block-time K launched single steps vs ONE fused(K) launch.

        Both sides chain C back into A (same semantics and flop count);
        medians over ``reps`` blocks keep the statistic stable.
        """
        a_phys, b_p, init_s, scatter_s = self.init_data()
        step, fstep = self._step, self.plan.fused_step(k)
        # the fused step writes in place on the card: give it its own buffer
        y = a_phys.clone()
        for _ in range(max(1, self.cfg.warmups)):
            step(a_phys, b_p)
            y = fstep(y, b_p)
        disp_timer, fused_timer = _LaunchTimer(self.device), _LaunchTimer(self.device)

        def chain() -> torch.Tensor:
            x = a_phys
            for _ in range(k):
                x = step(x, b_p)
            return x

        for _ in range(reps):
            disp_timer(chain)
            y = fused_timer(lambda: fstep(y, b_p))
        disp, fused = disp_timer.seconds(), fused_timer.seconds()
        result = self._result(
            init_s, scatter_s, [t / k for t in fused], self.verify(y), fused_k=k
        )
        return {
            "k": k,
            "dispatched_s": float(np.median(disp)),
            "fused_s": float(np.median(fused)),
            "dispatched_min_s": min(disp),
            "fused_min_s": min(fused),
            "fused_speedup": float(np.median(disp) / np.median(fused)),
            "result": result,
        }

    def run_fused(self, k: int | None = None, reps: int = 3) -> BenchResult:
        """One launch chaining k multiplies; timed ``reps`` times after
        ``max(1, warmups)`` warmups.

        ``iter_seconds`` holds per-multiply seconds (time / k).  The loop
        rebinds A to the produced C (on the card C is A's storage).
        """
        cfg = self.cfg
        k = cfg.iterations if k is None else k
        fstep = self.plan.fused_step(k)
        a_phys, b_p, init_s, scatter_s = self.init_data()
        x = a_phys
        for _ in range(max(1, cfg.warmups)):
            x = fstep(x, b_p)
        timer = _LaunchTimer(self.device)
        self._window()
        for _ in range(reps):
            x = timer(lambda: fstep(x, b_p))
        times = timer.seconds()
        self._window()
        times = [t / k for t in self._slowest(times)]
        verified = self.verify(x)
        return self._result(init_s, scatter_s, times, verified, fused_k=k)
