"""Ranks of the lattice-batch and ranked-tuner tests: gloo processes that
rendezvous through a ``file://`` store, one CPU thread each.

This module imports torch and ``repro_torch`` only (never JAX), so a
spawned rank loads it without the reference.  Every rank writes what it
holds to ``rank<r>.npz`` (or ``.json``) in the output directory; the tests
compare them.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.su3 import plan as tplan
from repro_torch.launch import mesh as meshes

L = 4
TILE = 64  # 4 devices x 64 = 256 = L^4: no site padding on any mesh
BATCH = 5
TABLE_SLOTS = 4
DEPTHS = [0, 1, 3, 4]
MAX_K = 4
SEED = 11


def config() -> tplan.EngineConfig:
    return tplan.EngineConfig(L=L, tile=TILE, iterations=1, warmups=0)


def su3(n: int, seed: int) -> np.ndarray:
    """Random SU(3) matrices (n, 4, 3, 3) complex64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, 4, 3, 3)) + 1j * rng.standard_normal((n, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def inputs() -> dict[str, np.ndarray]:
    """A batch of :data:`BATCH` random lattices ``a`` (B, L^4, 4, 3, 3), their
    B's ``b`` (B, 4, 3, 3) and the slot depths."""
    a = np.stack([su3(L**4, SEED + i) for i in range(BATCH)])
    b = su3(BATCH, SEED + 100)
    return {"a": a, "b": b, "depths": np.array(DEPTHS, np.int32)}


def bits(x: torch.Tensor) -> np.ndarray:
    x = torch.view_as_real(x) if x.is_complex() else x
    return x.contiguous().view(torch.int32).numpy().copy()


def spawn_within(fn, world: int, timeout: float, *args) -> None:
    """Run ``fn(rank, store, *args)`` on ``world`` gloo ranks; a rank that
    fails, or the ranks outliving ``timeout`` seconds, fail the call (the
    ranks are then killed: none is left hanging)."""
    with tempfile.TemporaryDirectory() as d:
        ctx = torch.multiprocessing.start_processes(
            fn, args=(os.path.join(d, "store"),) + args, nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()


def _start(rank: int, store: str, world: int) -> None:
    torch.set_num_threads(1)
    meshes.init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=world)


def _stop() -> None:
    """Leave the group together: no rank tears its connections down while
    another is still talking to it."""
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def batch_rank(rank: int, store: str, world: int, hosts: int, dph: int, out_dir: str) -> None:
    """One rank of ``MeshSpec(hosts, dph)``: the runner's blocks, its
    ``multiply`` at k=1 and 3 (the whole batch), ``run`` on the rank's
    blocks, the megakernel over a :data:`TABLE_SLOTS`-slot table split by
    rank and over a 3-slot table (unsharded: whole on every rank), and the
    refusals."""
    _start(rank, store, world)
    out: dict[str, np.ndarray] = {}
    try:
        data = inputs()
        a, b = torch.from_numpy(data["a"]), torch.from_numpy(data["b"])
        runner = tplan.BatchedLatticeRunner(config(), meshes.MeshSpec(hosts, dph).resolve("cpu"))
        plan = runner.plan
        out["blocks"] = np.array([(x.index, x.lo, x.hi) for x in runner.blocks(BATCH)])
        for k in (1, 3):
            out[f"multiply/{k}"] = runner.multiply(a, b, k=k).numpy()
        local, local_b = runner.pack_batch(a), runner.pack_b_batch(b)
        out["local_shape"] = np.array(local.shape)
        out["run/3"] = bits(runner.run(local, local_b, k=3))
        blocks = plan.slot_table_blocks(TABLE_SLOTS)
        lo, hi = blocks[0].lo, blocks[-1].hi
        out["mega4/range"] = np.array([lo, hi])
        table, table_b = runner.pack_batch(a[:TABLE_SLOTS]), runner.pack_b_batch(b[:TABLE_SLOTS])
        ks = torch.tensor(DEPTHS[lo:hi], dtype=torch.int32)
        out["mega4"] = bits(plan.fused_batched_step(TABLE_SLOTS, max_k=MAX_K)(table, table_b, ks))
        whole = torch.stack([runner.pack_lattice(x, "cpu") for x in a[:3]])
        whole_b = torch.stack([plan.codec.pack_b(x) for x in b[:3]])
        out["mega3/blocks"] = np.array([(x.index, x.lo, x.hi) for x in plan.slot_table_blocks(3)])
        out["mega3"] = bits(plan.fused_batched_step(3, max_k=MAX_K)(
            whole, whole_b, torch.tensor(DEPTHS[:3], dtype=torch.int32)))
        refusals = []
        for bad in (lambda: tplan.BatchedLatticeRunner(config(), meshes.MeshSpec(hosts, dph)
                                                       .resolve(torch.device("cuda"))),
                    lambda: plan.lattice_batch_blocks(BATCH)):
            try:
                bad()
                refusals.append("")
            except (ValueError, RuntimeError) as e:
                refusals.append(f"{type(e).__name__}: {e}")
        out["refusals"] = np.array(refusals)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        _stop()


def tune_rank(rank: int, store: str, world: int, hosts: int, tune_L: int, cache_dir: str,
              out_dir: str) -> None:
    """One rank of the ranked tuners: ``best_stencil_config`` and
    ``best_cg_config`` at ``hosts`` slabs twice (the second from the
    cache), counting the cache writes and the timed measurements; then
    ``hosts=1`` (refused before any measurement); then a bitwise failure
    injected on rank 1 only into one stencil and one CG candidate."""
    _start(rank, store, world)
    res: dict = {"rank": rank}
    writes, timed = [], []
    store_entry, best_seconds = autotune.store_cache_entry, autotune._best_seconds

    def counting_store(*args, **kw):
        writes.append(args[0])
        return store_entry(*args, **kw)

    def counting_seconds(*args, **kw):
        timed.append(1)
        return best_seconds(*args, **kw)

    autotune.store_cache_entry, autotune._best_seconds = counting_store, counting_seconds
    try:
        for name, fn in (("stencil", autotune.best_stencil_config),
                         ("cg", autotune.best_cg_config)):
            first = fn(L=tune_L, hosts=hosts, cache_directory=cache_dir, device="cpu",
                       hw=autotune.roofline.H100_SXM)
            n_timed = len(timed)
            second = fn(L=tune_L, hosts=hosts, cache_directory=cache_dir, device="cpu",
                        hw=autotune.roofline.H100_SXM)
            res[name] = {"first": first, "second": second, "timed": n_timed,
                         "timed_again": len(timed) - n_timed}
        res["writes"] = list(writes)
        timed.clear()
        try:
            autotune.best_stencil_config(L=tune_L, hosts=1, cache=False, device="cpu",
                                         hw=autotune.roofline.H100_SXM)
            res["hosts1"] = ""
        except ValueError as e:
            res["hosts1"] = str(e)
        res["hosts1_timed"] = len(timed)
        if rank == 1:
            autotune._same_bits = lambda x, y: False
        t0 = time.perf_counter()
        res["injected"] = {
            "stencil": autotune.measure_stencil_candidate(
                autotune.StencilCandidate(128, True, 1), L=tune_L, hosts=hosts, device="cpu"),
            "cg": autotune.measure_cg_candidate(
                autotune.CGCandidate(128, True), L=tune_L, hosts=hosts, device="cpu"),
        }
        res["injected_s"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        _stop()
