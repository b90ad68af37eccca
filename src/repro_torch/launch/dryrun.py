"""Dry run on the one card: every (architecture x input shape) cell traced
on ``meta`` tensors, and the SU3 fig7 curve as one multi-controller launch
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single  # 40 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --su3-fig7 \\
        --L 32 --device-counts 1,2,4 --controllers 2

**LM cells.**  The reference lowers and compiles each cell's step over a
mesh of placeholder devices and reads XLA's cost and memory analysis.  Here
:func:`trace_cell` builds the parameters, the optimizer state, the batch and
the decode state on the ``meta`` device (shapes without data: nothing is
allocated) and runs the cell's step on them (a train step with its backward
and AdamW update, a prefill, or a decode step) under
``torch.utils.flop_counter.FlopCounterMode`` and a counter of the bytes
every aten op reads and writes; those counts stand where XLA's cost
analysis stood.  The flash kernels' plain versions give the attention's
shapes there, and each call of one adds the bytes the kernel would move.
:class:`CellPolicy`, :func:`model_flops` and :func:`estimate_memory` are the reference's
arithmetic, integer for integer, over the rules of
``distributed/sharding.py``: ``--mesh single`` is the one card (a 1 x 1
mesh), ``--mesh multi`` the reference's fallback mesh ``(2, 2, n / 4)`` of
n = 16 logical devices (its tests' count), analytic only.  :func:`run_cell` writes the
reference's JSON fields, with an H100 roofline (compute and HBM terms; no
collective on one card), to ``experiments/dryrun_torch/``.

**SU3 fig7.**  ``--su3-fig7`` starts ``--controllers`` identical controller
processes, each running the strong-scaling curve over ``MeshSpec`` plans of
1, 2, ... t-slabs of the one card (``--device cpu``: of the CPU) in both
placements; the launcher fails unless every slab count's result digest
equals the one-slab digest and every controller's table equals rank 0's.
The reference runs the curve on its VersionX einsum; the port runs its
multiply kernel (``su3_mult_planar``; its plain version on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import roofline
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import LogicalMesh, MeshRules
from repro_torch.kernels import flash_attention
from repro_torch.models import common, registry
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "experiments" / "dryrun_torch"
ONE_CARD = LogicalMesh.of(data=1, model=1)
# the reference's fallback (pod, data, model) mesh over its tests' 16 forced
# devices; logical here: the rules' arithmetic, no device
MULTI = LogicalMesh.of(pod=2, data=2, model=4)


@dataclasses.dataclass
class CellPolicy:
    """Memory/precision policy for a cell (recorded in the report)."""

    param_dtype: str
    moment_dtype: str
    cache_dtype: str
    microbatches: int

    @staticmethod
    def for_cell(cfg: ModelConfig, shape: ShapeConfig) -> "CellPolicy":
        big = cfg.n_params() > 60e9
        if shape.kind == "train":
            mb = 1
            if shape.seq_len * shape.global_batch >= 2**20:
                mb = 16 if big else 4
            return CellPolicy(
                param_dtype="bfloat16" if big else "float32",
                moment_dtype="bfloat16" if big else "float32",
                cache_dtype="bfloat16",
                microbatches=mb,
            )
        return CellPolicy(param_dtype="bfloat16", moment_dtype="bfloat16",
                          cache_dtype="bfloat16", microbatches=1)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The assignment's formula: 6 N D to train (N active for MoE), 2 N D
    to serve."""
    n = cfg.active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def _itemsize(dtype: str | torch.dtype) -> int:
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty((), dtype=dt).element_size()


def _sharded_bytes(spec_tree: common.SpecTree, mesh: LogicalMesh, rules: MeshRules,
                   dtype: str) -> int:
    """Per-device bytes of a ParamSpec tree under the resolved rules."""
    total = 0
    for _, s in common.tree_leaves(spec_tree):
        spec = sharding.resolve_spec(s.axes, s.shape, mesh, rules)
        total += sharding.local_numel(s.shape, spec, mesh) * _itemsize(dtype)
    return total


def _state_bytes(state: Any, mesh: LogicalMesh, rules: MeshRules,
                 kv_seq_shard: bool = False) -> int:
    """Per-device bytes of a decode/prefill state tree under the state rules
    (each leaf by its key's last name and its rank)."""
    total = 0
    for path, t in common.tree_leaves(state):
        spec = sharding.state_spec_for(common.path_name(path), tuple(t.shape), mesh, rules,
                                       kv_seq_shard=kv_seq_shard)
        total += sharding.local_numel(tuple(t.shape), spec, mesh) * t.element_size()
    return total


def _meta_state(cfg: ModelConfig, api, shape: ShapeConfig, dtype: str) -> Any:
    """The cell's decode state on ``meta``: ``api.init_state`` at the
    shape's batch and length in the cache dtype."""
    return api.init_state(cfg, shape.global_batch, shape.seq_len, getattr(torch, dtype),
                          device="meta")


def _hardware() -> roofline.HardwareSpec:
    """The card's spec, or the H100 SXM's where no known card is present."""
    return roofline.current_hardware() or roofline.H100_SXM


def estimate_memory(
    cfg: ModelConfig, shape: ShapeConfig, mesh: LogicalMesh, rules: MeshRules,
    policy: CellPolicy, api, *, kv_seq_shard: bool = False,
) -> dict[str, Any]:
    """The reference's analytic memory model per device: parameters (and for
    training two moments, f32 gradients, one bf16 residual vector per layer
    and local token, and twice a layer's widest f32 intermediate), or
    parameters, the decode state and the widest bf16 intermediate.
    ``fits_h100_80g``: the total within the card's memory."""
    spec_tree = api.spec(cfg)
    p_bytes = _sharded_bytes(spec_tree, mesh, rules, policy.param_dtype)
    out: dict[str, Any] = {"params_bytes": p_bytes}
    dp = sharding.axis_size(mesh, rules.data_axes)
    widest = max(cfg.d_ff, cfg.d_model * 4, cfg.ssm_expand * cfg.d_model * 2)
    if shape.kind == "train":
        m_bytes = _sharded_bytes(spec_tree, mesh, rules, policy.moment_dtype)
        g_bytes = _sharded_bytes(spec_tree, mesh, rules, "float32")
        tokens_local = shape.global_batch * shape.seq_len // max(policy.microbatches, 1) // dp
        resid = cfg.n_layers * tokens_local * cfg.d_model * 2  # bf16
        trans = 2 * tokens_local * widest * 4
        out.update(opt_bytes=2 * m_bytes, grad_bytes=g_bytes, residual_bytes=resid,
                   transient_bytes=trans,
                   total_bytes=p_bytes + 2 * m_bytes + g_bytes + resid + trans)
    else:
        state = _meta_state(cfg, api, shape, policy.cache_dtype)
        s_bytes = _state_bytes(state, mesh, rules, kv_seq_shard=kv_seq_shard)
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
        tokens_local = max(tokens // dp, 1)
        trans = 2 * tokens_local * widest * 2
        out.update(state_bytes=s_bytes, transient_bytes=trans,
                   total_bytes=p_bytes + s_bytes + trans)
    out["fits_h100_80g"] = out["total_bytes"] <= _hardware().hbm_bytes
    return out


@dataclasses.dataclass
class _KernelTally:
    """The flash kernels' traffic in a trace (see :func:`_kernel_traffic`)."""

    inside: int = 0  # > 0 while a plain version runs
    bytes: int = 0


@contextlib.contextmanager
def _kernel_traffic():
    """Within it, each call of a flash kernel's plain version (which stands
    for the kernel on ``meta``) adds the bytes the kernel moves, each tensor
    operand read once and each result written once, and is marked running,
    so that :class:`_ByteCounter` leaves out the plain version's chunk
    scores, which the kernel keeps on chip.  Yields the tally."""
    tally = _KernelTally()

    def counted(fn):
        def call(*args, **kwargs):
            tally.inside += 1
            try:
                res = fn(*args, **kwargs)
            finally:
                tally.inside -= 1
            tensors = [*args, *(res if isinstance(res, tuple) else (res,))]
            tally.bytes += sum(t.numel() * t.element_size() for t in tensors
                               if isinstance(t, torch.Tensor))
            return res
        return call

    names = ("flash_attention_plain", "flash_attention_bwd_plain")
    saved = {name: getattr(flash_attention, name) for name in names}
    for name, fn in saved.items():
        setattr(flash_attention, name, counted(fn))
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(flash_attention, name, fn)


class _ByteCounter(TorchDispatchMode):
    """Bytes every aten op reads and writes: its tensor operands and results,
    once per op (views move nothing and are skipped), the counterpart of
    the bytes XLA's cost analysis counts per HLO op.  The ops of a flash
    plain version are left out (``tally.inside``): on the card the kernel
    keeps its scores on chip, and :func:`_kernel_traffic` adds what it
    moves instead."""

    def __init__(self, tally: _KernelTally) -> None:
        super().__init__()
        self.tally = tally
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.tally.inside and not getattr(func, "is_view", False):
            self.ops += 1
            for x in (*args, *(kwargs or {}).values(), *(out if isinstance(out, (tuple, list))
                                                          else (out,))):
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
                elif isinstance(x, (tuple, list)):
                    self.bytes += sum(t.numel() * t.element_size() for t in x
                                      if isinstance(t, torch.Tensor))
        return out


def op_bytes(fn: Callable[[], Any]) -> int:
    """The bytes every aten op of one call ``fn()`` reads and writes, as
    :func:`trace_cell` counts them (:class:`_ByteCounter`; a flash plain
    version counts the bytes its kernel moves)."""
    with _kernel_traffic() as tally, _ByteCounter(tally) as moved:
        fn()
    return moved.bytes + tally.bytes


def _meta_params(cfg: ModelConfig, api, dtype: str):
    """The model's parameters on ``meta`` in ``dtype``, as ``api.init`` lays
    them out (the reference's tree, stacks split per layer)."""
    tree: dict[str, Any] = {}
    for path, s in common.tree_leaves(api.spec(cfg)):
        common.tree_set(tree, path, torch.empty(s.shape, dtype=getattr(torch, dtype),
                                                device="meta"))
    return api.from_tree(cfg, tree)


def _tree_bytes(tree: Any) -> int:
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_tree_bytes(v) for _, v in common.tree_leaves(tree))


def trace_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    policy: CellPolicy | None = None,
    fsdp: bool = True,
    kv_seq_shard: bool = False,
    grad_acc_dtype: str = "float32",
    microbatches: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Build one cell on ``meta`` and run its step under the flop and byte
    counters (the counterpart of the reference's ``lower_cell``).

    Returns:
        ``(counts, meta)``: ``counts`` holds the traced ``flops``, ``bytes``
        and aten ``ops`` and the meta trees' bytes (``params_bytes``,
        ``opt_bytes``, ``batch_bytes``, ``state_bytes``); ``meta`` the
        reference's record of the policy and options.

    Raises:
        RuntimeError: the meta trees' bytes disagree with
            :func:`estimate_memory` on one card.
    """
    policy = policy or CellPolicy.for_cell(cfg, shape)
    if microbatches is not None:
        policy = dataclasses.replace(policy, microbatches=microbatches)
    api = registry.get(cfg)
    params = _meta_params(cfg, api, policy.param_dtype)
    batch = {name: torch.empty(shp, dtype=dt, device="meta")
             for name, (shp, dt) in registry.input_specs(cfg, shape).items()}
    counts: dict[str, Any] = {"params_bytes": _tree_bytes(params),
                              "batch_bytes": _tree_bytes(batch)}
    with _kernel_traffic() as tally:
        flops, moved = FlopCounterMode(display=False), _ByteCounter(tally)
        if shape.kind == "train":
            common.trainable(params)
            opt_cfg = adamw.AdamWConfig(moment_dtype=policy.moment_dtype)
            opt_state = adamw.init(params, opt_cfg)
            counts["opt_bytes"] = _tree_bytes({"m": opt_state["m"], "v": opt_state["v"]})
            step = make_train_step(cfg, opt_cfg, microbatches=policy.microbatches,
                                   grad_acc_dtype=grad_acc_dtype, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk)
            with flops, moved:
                step(params, opt_state, batch)
        else:
            state = _meta_state(cfg, api, shape, policy.cache_dtype)
            counts["state_bytes"] = _tree_bytes(state)
            with torch.no_grad(), flops, moved:
                if shape.kind == "prefill":
                    api.prefill(params, batch, state, cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)
                else:  # decode: one token against a cache of seq_len, written at its end
                    api.decode_step(params, batch, state, shape.seq_len - 1, cfg)
    counts.update(flops=flops.get_total_flops(), bytes=moved.bytes + tally.bytes,
                  attention_bytes=tally.bytes, ops=moved.ops)
    want = estimate_memory(cfg, shape, ONE_CARD, sharding.default_rules(ONE_CARD, fsdp=fsdp),
                           policy, api, kv_seq_shard=kv_seq_shard)
    for key in ("params_bytes", "state_bytes"):
        if key in counts and counts[key] != want[key]:
            raise RuntimeError(f"{cfg.name}/{shape.name}: the meta {key} {counts[key]} differ "
                               f"from estimate_memory's {want[key]} on one card")
    meta = {"policy": dataclasses.asdict(policy), "fsdp": fsdp, "kv_seq_shard": kv_seq_shard,
            "grad_acc_dtype": grad_acc_dtype, "q_chunk": q_chunk, "kv_chunk": kv_chunk}
    return counts, meta


def roofline_report(name: str, *, flops: float, bytes_moved: float, n_devices: int,
                    hw: roofline.HardwareSpec, model_flops_total: float) -> dict[str, Any]:
    """The reference's roofline fields for a traced cell on the card: the
    flops and bytes split evenly over ``n_devices``; compute at the bf16
    tensor-core peak, HBM at its rate; no collective and no issue term
    (one card)."""
    f_dev, b_dev = flops / n_devices, bytes_moved / n_devices
    terms = {"compute": f_dev / hw.peak_flops_bf16, "memory": b_dev / hw.hbm_bw,
             "collective": 0.0, "issue": 0.0}
    bound = max(terms.values())
    useful = model_flops_total / n_devices / hw.peak_flops_bf16
    return {
        "name": name, "hw": hw.name, "n_chips": n_devices,
        "flops_per_device": f_dev, "bytes_per_device": b_dev,
        "collective_link_bytes": 0.0, "collective_by_kind": {},
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": 0.0, "issue_s": 0.0, "instructions_per_device": 0.0,
        "instr_by_class": {}, "dominant": max(terms, key=terms.get), "bound_s": bound,
        "model_flops": model_flops_total,
        "useful_flops_ratio": model_flops_total / flops if flops else 0.0,
        "roofline_fraction": useful / bound if bound else 0.0,
        "flop_counter": "torch.utils.flop_counter.FlopCounterMode",
        "bytes_counter": "operands and results of every eager aten op but views; the flash "
                         "kernels' operands and results once each",
    }


def run_cell(
    arch: str,
    shape_name: str,
    mesh: LogicalMesh,
    mesh_label: str,
    *,
    verbose: bool = True,
    overrides: dict[str, Any] | None = None,
    tag: str = "",
    results_dir: pathlib.Path = RESULTS_DIR,
) -> dict[str, Any]:
    """Trace one cell, write its JSON into ``results_dir`` and return it; an
    inapplicable cell prints ``[skip]`` with the reason."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    cell = f"{arch}/{shape_name}/{mesh_label}{('#' + tag) if tag else ''}"
    if not ok:
        if verbose:
            print(f"[skip] {cell}: {reason}")
        return {"cell": cell, "status": "skipped", "reason": reason}
    hw = _hardware()
    t0 = time.time()
    counts, meta = trace_cell(cfg, shape, **(overrides or {}))
    t_trace = time.time() - t0
    rules = sharding.default_rules(mesh, fsdp=meta["fsdp"])
    analytic = estimate_memory(cfg, shape, mesh, rules, CellPolicy(**meta["policy"]),
                               registry.get(cfg), kv_seq_shard=meta["kv_seq_shard"])
    report = roofline_report(cell, flops=counts["flops"], bytes_moved=counts["bytes"],
                             n_devices=mesh.size, hw=hw,
                             model_flops_total=model_flops(cfg, shape))
    out = {
        "cell": cell, "status": "ok", "arch": arch, "shape": shape_name, "mesh": mesh_label,
        "mesh_shape": mesh.shape, "n_devices": mesh.size,
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "memory": {k: v for k, v in counts.items() if k.endswith("_bytes")},
        "memory_analytic": analytic, "roofline": report, "traced_ops": counts["ops"], **meta,
    }
    if verbose:
        gib = analytic["total_bytes"] / 2**30
        print(f"[ok] {cell}: traced {t_trace:.1f}s | analytic {gib:.2f} GiB/dev "
              f"(fits h100 80g: {analytic['fits_h100_80g']})")
        print(f"     {cell}: compute {report['compute_s'] * 1e3:.3f} ms | memory "
              f"{report['memory_s'] * 1e3:.3f} ms | collective 0.000 ms -> "
              f"{report['dominant']}-bound; useful/traced flops "
              f"{report['useful_flops_ratio']:.3f}, roofline frac "
              f"{report['roofline_fraction']:.3f}")
    results_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    (results_dir / f"{arch}__{shape_name}__{mesh_label}{suffix}.json").write_text(
        json.dumps(out, indent=2, default=str))
    return out


def mesh_for(label: str) -> LogicalMesh:
    """``single``: the one card, 1 x 1; ``multi``: :data:`MULTI`."""
    return MULTI if label == "multi" else ONE_CARD


# ---------------------------------------------------------------------------
# SU3 fig7: strong scaling as one multi-controller launch
# ---------------------------------------------------------------------------


def su3_result(plan, seed: int):
    """The canonical C lattice (live sites, complex64 numpy) of a seeded
    random (A, B) pair through ``plan.step``: the draw covers the L^4 live
    sites only and the padding is zeros, so plans whose padding differs
    (other slab counts, other tiles) see the same live inputs."""
    import numpy as np

    n = plan.cfg.shape.n_sites
    rng = np.random.default_rng(seed)
    shape = (n, 4, 3, 3)
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype("complex64")
    b = (rng.standard_normal((4, 3, 3)) + 1j * rng.standard_normal((4, 3, 3))).astype("complex64")
    a = np.concatenate([a, np.zeros((plan.padded_sites - n, 4, 3, 3), "complex64")], axis=0)
    dev = plan.device
    c_phys = plan.step(plan.codec.pack(torch.from_numpy(a).to(dev)).contiguous(),
                       plan.codec.pack_b(torch.from_numpy(b).to(dev)).contiguous())
    return plan.unpack(c_phys).cpu().numpy()


def _su3_result_digest(plan, seed: int) -> str:
    """sha256 of :func:`su3_result`: the multiply is site-local, so every
    slab count's digest must be the one-slab digest; any difference is a
    divergence."""
    return hashlib.sha256(su3_result(plan, seed).tobytes()).hexdigest()


def su3_fig7_rows(
    L: int,
    device_counts: tuple[int, ...],
    hosts: int | None = None,
    seed: int = 0,
    iterations: int = 3,
    device: str | None = None,
) -> tuple[list[dict], dict[str, str]]:
    """The fig7 strong-scaling curve over ``MeshSpec`` plans: for each count
    n, min(hosts, n) t-slabs (``hosts`` None: n) of n simulated devices on
    the one ``device`` (None: the card), in both placements, through the
    multiply kernel.

    Returns:
        ``(rows, digests)``: rows named ``fig7_{placement}_d{n}`` with
        ``hosts`` and the halo fields, and ``{"d{n}": sha256}`` of the
        sharded plans' results for the launcher's divergence gate.
    """
    from repro_torch.core.su3.engine import EngineConfig, SU3Engine
    from repro_torch.launch.mesh import MeshSpec

    rows: list[dict] = []
    digests: dict[str, str] = {}
    for n in device_counts:
        h = min(n if hosts is None else hosts, n)
        spec = MeshSpec(hosts=h, devices_per_host=n // h)
        for placement in ("sharded", "host_scatter"):
            cfg = EngineConfig(L=L, variant="cuda", placement=placement,
                               iterations=iterations, warmups=1, tile=128)
            eng = SU3Engine(cfg, spec.resolve(device))
            row = eng.run().row()
            row["name"] = f"fig7_{placement}_d{n}"
            row["hosts"] = h
            row.update(eng.plan.halo().as_dict() if L**4 % max(h, 1) == 0 else {})
            rows.append(row)
            if placement == "sharded":
                digests[f"d{n}"] = _su3_result_digest(eng.plan, seed)
    return rows, digests


def _su3_fig7_worker(args: argparse.Namespace) -> None:
    """One controller: the curve and its digests, written to ``args.out``."""
    counts = tuple(int(x) for x in args.device_counts.split(","))
    rows, digests = su3_fig7_rows(args.L, counts, args.hosts, seed=args.seed,
                                  iterations=args.iterations, device=args.device)
    device = (torch.cuda.get_device_name(0) if args.device in (None, "cuda") else args.device)
    payload = {"rank": args.rank, "device": device, "rows": rows, "digests": digests}
    pathlib.Path(args.out).write_text(json.dumps(payload, default=str))


def su3_fig7_launch(
    L: int,
    device_counts: tuple[int, ...],
    hosts: int | None,
    controllers: int,
    seed: int = 0,
    iterations: int = 3,
    timeout: int = 600,
    device: str | None = None,
) -> list[dict]:
    """Start ``controllers`` identical fig7 workers; gate on divergence.

    Every worker runs the whole curve.  The launcher then requires, within
    each controller, every slab count's digest to equal the one at the
    least device count (one slab), and across controllers every digest
    table to equal rank 0's.

    Raises:
        SystemExit: a controller failed or timed out, or a digest diverged.

    Returns:
        Controller 0's rows, each stamped with ``controllers``.
    """
    counts = ",".join(str(c) for c in device_counts)
    tmpdir = tempfile.mkdtemp(prefix="su3_fig7_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    outs, procs = [], []
    for rank in range(controllers):
        out = pathlib.Path(tmpdir) / f"controller_{rank}.json"
        outs.append(out)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--su3-fig7-worker",
               "--rank", str(rank), "--out", str(out), "--L", str(L), "--device-counts", counts,
               "--seed", str(seed), "--iterations", str(iterations)]
        cmd += [] if hosts is None else ["--hosts", str(hosts)]
        cmd += [] if device is None else ["--device", device]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    payloads = []
    try:
        for rank, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise SystemExit(f"su3-fig7 controller {rank} timed out")
            if proc.returncode != 0:
                raise SystemExit(f"su3-fig7 controller {rank} failed:\n{err[-2000:]}")
            payloads.append(json.loads(outs[rank].read_text()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reference = payloads[0]["digests"]
    one_slab = reference.get(f"d{min(device_counts)}")
    failures = []
    for p in payloads:
        for point, digest in p["digests"].items():
            if digest != one_slab:
                failures.append(f"controller {p['rank']} {point}: {digest[:12]} != "
                                f"one-slab {str(one_slab)[:12]}")
        if p["digests"] != reference:
            failures.append(f"controller {p['rank']} digest table diverges from rank 0")
    if failures:
        for f in failures:
            print(f"[DIVERGENCE] {f}", file=sys.stderr)
        raise SystemExit(1)
    rows = payloads[0]["rows"]
    for row in rows:
        row["controllers"] = controllers
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="run every applicable cell")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="shard the KV cache's sequence dim over the model axis where the "
                         "kv heads cannot be")
    ap.add_argument("--grad-acc-dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="", help="suffix for the result JSON")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    # SU3 fig7 multi-controller dry run
    ap.add_argument("--su3-fig7", action="store_true",
                    help="launch the SU3 strong-scaling curve as one multi-controller "
                         "dry run (divergence-gated)")
    ap.add_argument("--su3-fig7-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--device-counts", default="1,2,4")
    ap.add_argument("--hosts", type=int, default=None,
                    help="t-slabs at most (default: one per device)")
    ap.add_argument("--controllers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu, for --su3-fig7")
    args = ap.parse_args(argv)

    if args.su3_fig7_worker:
        _su3_fig7_worker(args)
        return
    if args.su3_fig7:
        counts = tuple(int(x) for x in args.device_counts.split(","))
        rows = su3_fig7_launch(args.L, counts, args.hosts, args.controllers, seed=args.seed,
                               iterations=args.iterations, device=args.device)
        print(json.dumps(rows, default=str))
        return

    labels = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ALL_ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    overrides: dict[str, Any] = {}
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.kv_seq_shard:
        overrides["kv_seq_shard"] = True
    if args.grad_acc_dtype != "float32":
        overrides["grad_acc_dtype"] = args.grad_acc_dtype
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches
    failures = 0
    for label in labels:
        mesh = mesh_for(label)
        print(f"== mesh {label}: {mesh.shape} ==")
        for arch, shape_name in cells:
            try:
                run_cell(arch, shape_name, mesh, label, overrides=overrides, tag=args.tag,
                         results_dir=pathlib.Path(args.results_dir))
            except Exception as e:  # a failing cell is a fault of the port
                failures += 1
                print(f"[FAIL] {arch}/{shape_name}/{label}: {type(e).__name__}: {e}")
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
