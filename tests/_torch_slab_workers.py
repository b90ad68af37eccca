"""Ranks of the ranked-slab tests: ``torch.multiprocessing.spawn``
processes on gloo, rendezvous through a ``file://`` store, one CPU thread
each (``_torch_mesh_workers.spawn``).

This module imports torch and ``repro_torch`` only (never JAX), so a
spawned rank loads it without the reference.  Every rank writes what it
holds to ``rank<r>.npz`` in the output directory: its tensors' bits, their
shapes and its checks; the test compares them with the one-process plan's.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.chaos import FaultPlan, FaultSpec
from repro_torch.core.autotune import _cg_measure_problem
from repro_torch.core.su3 import layouts
from repro_torch.core.su3 import plan as tplan
from repro_torch.core.su3.engine import SU3Engine
from repro_torch.launch import mesh as meshes
from repro_torch.obs import Tracer, provenance_block

# (label, layout, dtype, accum, compression): test_torch_multislab's forms
FORMS = [
    ("soa f32", "soa", "float32", "", "none"),
    ("aosoa f32", "aosoa", "float32", "", "none"),
    ("soa bf16+f32", "soa", "bfloat16", "float32", "none"),
    ("soa two-row", "soa", "float32", "", "two_row"),
]
CG_FORMS = ("soa f32", "aosoa f32", "soa two-row")  # f32 storage: fused == composed bitwise
SCHEDULES = [(overlap, depth) for overlap in (True, False) for depth in (1, 2)]
FIELD_SEED = 3
TILE = 64
FAULT_SEED = 7


def config(L: int, form: str) -> tplan.EngineConfig:
    _, layout, dtype, accum, comp = next(f for f in FORMS if f[0] == form)
    return tplan.EngineConfig(L=L, layout=layouts.Layout(layout), dtype=dtype,
                              accum_dtype=accum, compression=comp, tile=TILE, iterations=1,
                              warmups=0)


def su3(n_sites: int, seed: int) -> np.ndarray:
    """Random SU(3) links (n_sites, 4, 3, 3) complex64."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def field(L: int, seed: int = FIELD_SEED) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random links u (L^4, 4, 3, 3), a vector field v (L^4, 3) and a B
    (4, 3, 3) from ``seed``."""
    rng = np.random.default_rng(seed + 100)
    n = L**4
    v = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(np.complex64)
    return su3(n, seed), v, su3(1, seed + 1)[0]


def bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy().copy()


def _cg(plan: tplan.ExecutionPlan, u, b, fused: bool) -> dict[str, np.ndarray]:
    res = plan.cg_solve(u, b, fused=fused, overlap=True)
    return {"x": bits(res.x_p), "residuals": np.array(res.residuals),
            "iterations": np.array(res.iterations), "converged": np.array(res.converged),
            "x_whole": plan.unpack_vec(res.x_p).numpy()}


def slab_rank(rank: int, store: str, world: int, hosts: int, L: int, out_dir: str,
              dph: int = 1) -> None:
    """One rank of ``MeshSpec(hosts, dph)`` at L: every form's first-touch
    init (and ``host_scatter``, ``replicated``), ``step``, ``fused_step(3)``
    and the stencil at both ``overlap`` values and depths 1 and 2 on
    :func:`field`; fused and composed CG (twice fused) on
    ``_cg_measure_problem(L)`` in :data:`CG_FORMS`; ``SU3Engine.run``'s row;
    the provenance block; the refusals; a traced overlapped step's phase
    spans; a ``halo`` fault on rank 0 only."""
    torch.set_num_threads(1)
    meshes.init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    out: dict[str, np.ndarray] = {}
    try:
        spec = meshes.MeshSpec(hosts=hosts, devices_per_host=dph)
        u, v, b = field(L)
        for form, *_ in FORMS:
            plan = tplan.build_plan(config(L, form), spec.resolve("cpu"))
            out[f"{form}/site_range"] = np.array(plan.site_range)
            a, b_p, _, _ = plan.init_data()
            out[f"{form}/a"], out[f"{form}/a_shape"] = bits(a), np.array(a.shape)
            c = plan.step(a, b_p)
            out[f"{form}/step"], out[f"{form}/verify"] = bits(c), np.array(plan.verify(c))
            out[f"{form}/fused3"] = bits(plan.fused_step(3)(a.clone(), b_p))
            out[f"{form}/describe"] = np.array(plan.describe())
            tu, tv = plan.pack_gauge(u), plan.pack_rhs(v)
            out[f"{form}/random_step"] = plan.unpack(plan.step(tu, plan.codec.pack_b(
                torch.from_numpy(b)))).numpy()
            for overlap, depth in SCHEDULES:
                got = plan.stencil_step(overlap=overlap, depth=depth)(tu, tv)
                out[f"{form}/stencil/{overlap}/{depth}"] = bits(got)
                out[f"{form}/stencil_whole/{overlap}/{depth}"] = plan.unpack_vec(got).numpy()
            su, sv = plan.init_stencil_data()
            out[f"{form}/verify_stencil"] = np.array(plan.verify_stencil(
                plan.stencil_step()(su, sv)))
            if form in CG_FORMS:
                ub, bb = _cg_measure_problem(L)
                cu, cb = plan.pack_gauge(ub), plan.pack_rhs(bb)
                for name, fused in (("fused", True), ("fused_again", True),
                                    ("composed", False)):
                    for k, x in _cg(plan, cu, cb, fused).items():
                        out[f"{form}/cg/{name}/{k}"] = x
        cfg = config(L, "soa f32")
        for placement in ("host_scatter", "replicated"):
            plan = tplan.build_plan(dataclasses.replace(cfg, placement=placement),
                                    spec.resolve("cpu"))
            a, b_p, _, scatter_s = plan.init_data()
            out[f"{placement}/a"], out[f"{placement}/a_shape"] = bits(a), np.array(a.shape)
            out[f"{placement}/verify"] = np.array(plan.verify(plan.step(a, b_p)))
        plan = tplan.build_plan(cfg, spec.resolve("cpu"))
        tu, tv = plan.pack_gauge(u), plan.pack_rhs(v)
        step = plan.stencil_step(overlap=True)
        plan.tracer = Tracer()
        out["traced"] = bits(step(tu, tv))
        out["span_ranks"] = np.array([(s.name, s.attrs.get("rank", -1))
                                      for s in plan.tracer.spans() if s.name != "stencil.step"])
        plan.tracer = tplan.NULL_TRACER
        out["clean"] = bits(step(tu, tv))
        if rank == 0:
            plan.faults = FaultPlan(FAULT_SEED, {"halo": FaultSpec(probability=1.0,
                                                                  actions=("drop",))})
        out["faulted"] = bits(step(tu, tv))
        out["fired"] = np.array(getattr(plan.faults, "fired", 0))
        plan.faults = tplan.NULL_FAULT_PLAN
        out["after"] = bits(step(tu, tv))
        out["boundary"] = plan._boundary_geometry()["bidx"].numpy()
        out["face_peers"] = np.array(sorted(q for q, _, _ in
                                            plan._stencil_geometry()["halo1"].peers), np.int64)
        row = SU3Engine(dataclasses.replace(cfg, iterations=2), spec.resolve("cpu")).run().row()
        out["engine_row"] = np.array(json.dumps(row))
        prov = provenance_block()
        out["provenance"] = np.array([prov["dist_world"], prov["dist_backend"]])
        refusals = []
        for bad in (lambda: meshes.MeshSpec(hosts=world + 1).resolve("cpu"),
                    lambda: meshes.MeshSpec(hosts=hosts).resolve(torch.device("cuda"))):
            try:
                bad()
                refusals.append("")
            except (ValueError, RuntimeError) as e:
                refusals.append(str(e))
        out["refusals"] = np.array(refusals)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


def one_process(hosts: int, L: int, dph: int = 1) -> dict[str, np.ndarray]:
    """What :func:`slab_rank` computes, on the one-process plan of
    ``MeshSpec(hosts, dph)`` (every slab in one tensor)."""
    out: dict[str, np.ndarray] = {}
    spec = meshes.MeshSpec(hosts=hosts, devices_per_host=dph)
    u, v, b = field(L)
    for form, *_ in FORMS:
        plan = tplan.build_plan(config(L, form), spec.resolve("cpu"))
        a, b_p, _, _ = plan.init_data()
        out[f"{form}/a"] = bits(a)
        out[f"{form}/step"] = bits(plan.step(a, b_p))
        out[f"{form}/fused3"] = bits(plan.fused_step(3)(a.clone(), b_p))
        tu, tv = plan.pack_gauge(u), plan.pack_rhs(v)
        for overlap, depth in SCHEDULES:
            out[f"{form}/stencil/{overlap}/{depth}"] = bits(
                plan.stencil_step(overlap=overlap, depth=depth)(tu, tv))
        if form in CG_FORMS:
            ub, bb = _cg_measure_problem(L)
            for k, x in _cg(plan, plan.pack_gauge(ub), plan.pack_rhs(bb), True).items():
                out[f"{form}/cg/{k}"] = x
    return out
