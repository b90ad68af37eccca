"""SU3Service of the PyTorch port against the JAX reference's, end to end.

One scripted stream — multiplies at L=2 and L=3 with k = 1..4, a stencil
batch and a CG solve, all random SU(3) data from numpy seeds — goes through
both services in each dispatch mode (batch-per-step, continuous,
megakernel) on the CPU, where the CUDA kernels run their plain versions.
Results per request agree within ``verify_tolerance`` (XLA contracts FMAs,
so the frameworks are not bitwise equal at f32), and what the scheduler
did — completions, dispatches, iterations, mid-chain admits — is equal.
Inside the port the three modes give the same bits.

The chaos runs check the rollback that immutable JAX arrays gave for free:
with a fault plan armed, a poisoned dispatch is rolled back and retried, so
every result equals the fault-free run's bit for bit, and the fault log
equals the reference's.  Each JAX run is computed once per module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import FaultPlan as JFaultPlan
from repro.chaos import FaultSpec as JFaultSpec
from repro.serve.su3 import BatcherConfig as JBatcherConfig
from repro.serve.su3 import ServiceConfig as JServiceConfig
from repro.serve.su3 import SU3Service as JSU3Service
from repro_torch.chaos import FaultPlan, FaultSpec
from repro_torch.core.autotune import _cg_measure_problem
from repro_torch.core.su3.plan import verify_tolerance
from repro_torch.serve.su3 import BatcherConfig, RequestFailure, ServiceConfig, SU3Service
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

MODES = {
    "batch": {},
    "continuous": {"continuous": True},
    "megakernel": {"continuous": True, "megakernel": True},
}
TOL = verify_tolerance("float32")
SCHED_KEYS = ("completed", "dispatches", "iterations", "midchain_admits", "host_dispatches",
              "kind_iterations", "admitted")


def _su3(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def _vec(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_sites, 3))
            + 1j * rng.standard_normal((n_sites, 3))).astype(np.complex64)


def _stream():
    """The scripted stream: (kind, operands..., k) tuples."""
    ops = []
    for i, (L, k) in enumerate([(2, 1), (2, 3), (3, 2), (2, 4), (3, 1), (2, 2), (3, 3), (2, 1)]):
        ops.append(("multiply", _su3(L**4, 10 + i), _su3(1, 50 + i)[0], k))
    for i in range(2):
        ops.append(("stencil", _su3(16, 80 + i), _vec(16, 90 + i), 1))
    u, b = _cg_measure_problem(2)
    ops.append(("solve", u, b, 1))
    return ops


def _config(cls_cfg, cls_batcher, mode: str, **kw):
    return cls_cfg(autotune=False, tile=16, chain_slots=4, solve_iters_per_step=4,
                   batcher=cls_batcher(max_batch=4, warm_batch_sizes=(1, 2, 4),
                                       max_queue_depth=32),
                   **MODES[mode], **kw)


def _drive(svc, ops, submit_at=4):
    """Submit the first ``submit_at`` ops, take two turns (chains are then in
    flight), submit the rest, drain; return the results in op order and the
    scheduling half of the metrics."""
    conv = jnp.asarray if isinstance(svc, JSU3Service) else torch.from_numpy

    def submit(op):
        kind, x, y, k = op
        if kind == "multiply":
            return svc.submit(conv(x), conv(y), k=k)
        if kind == "stencil":
            return svc.submit_stencil(conv(x), conv(y))
        return svc.submit_solve(conv(x), conv(y), tol=1e-6, max_iters=64)

    ids = [submit(op) for op in ops[:submit_at]]
    svc.step()
    svc.step()
    ids += [submit(op) for op in ops[submit_at:]]
    svc.run_until_drained()
    out = [svc.pop_result(i) for i in ids]
    snap = svc.metrics.snapshot()
    return out, {k: snap[k] for k in SCHED_KEYS}


@pytest.fixture(scope="module")
def stream():
    return _stream()


@pytest.fixture(scope="module")
def jax_runs(stream):
    return {mode: _drive(JSU3Service(_config(JServiceConfig, JBatcherConfig, mode)), stream)
            for mode in MODES}


@pytest.fixture(scope="module")
def port_runs(stream):
    return {mode: _drive(SU3Service(_config(ServiceConfig, BatcherConfig, mode),
                                    device="cpu"), stream)
            for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_matches_reference(jax_runs, port_runs, stream, mode):
    (jres, jsched), (tres, tsched) = jax_runs[mode], port_runs[mode]
    assert tsched == jsched
    assert tsched["completed"] == len(stream)
    for op, got, want in zip(stream, tres, jres):
        assert isinstance(got, torch.Tensor), got
        assert tuple(got.shape) == tuple(want.shape), op[0]
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL, op[0]


def test_stream_shows_each_mode_at_work(port_runs):
    """Continuous and megakernel modes admit mid-chain; the megakernel mode
    dispatches once per host and iteration."""
    sched = {mode: run[1] for mode, run in port_runs.items()}
    assert sched["batch"]["midchain_admits"] == 0
    assert sched["continuous"]["midchain_admits"] > 0
    assert sched["megakernel"]["midchain_admits"] > 0
    assert sched["megakernel"]["dispatches"] < sched["continuous"]["dispatches"]
    assert sched["megakernel"]["kind_iterations"]["solve"] == \
        sched["batch"]["kind_iterations"]["solve"]


def test_port_modes_give_the_same_bits(port_runs, stream):
    """One chain body behind every mode: a k-chain in one launch (batch),
    k single launches (continuous) and k megakernel depth-1 steps give
    the same bits; stencil and solve run the same plan code in each."""
    base = port_runs["batch"][0]
    for mode in ("continuous", "megakernel"):
        for op, x, y in zip(stream, port_runs[mode][0], base):
            assert torch.equal(x, y), (mode, op[0])


def test_results_are_new_tensors_not_views_of_a_live_table(stream):
    svc = SU3Service(_config(ServiceConfig, BatcherConfig, "megakernel"), device="cpu")
    multiplies = [op for op in stream if op[0] == "multiply"]
    ids = [svc.submit(torch.from_numpy(a), torch.from_numpy(b), k=k)
           for _, a, b, k in multiplies[:3]]
    svc.step()
    table = svc._tables[0][1]
    ptr = table.a_phys.data_ptr()
    svc.step()  # unguarded: the kernel writes the live table in place
    assert table.a_phys.data_ptr() == ptr
    svc.run_until_drained()
    outs = [svc.pop_result(rid) for rid in ids]
    kept = [x.clone() for x in outs]
    table.a_phys.fill_(7.0)  # what a later launch into the table would do
    assert all(torch.equal(x, y) for x, y in zip(outs, kept))


def _poison_plan(cls_plan, cls_spec):
    return cls_plan(3, {"kernel": cls_spec(probability=0.5, actions=("nan", "inf"),
                                           max_fires=4)})


def _chaos_run(svc, stream):
    ops = [op for op in stream if op[0] == "multiply"]
    return _drive(svc, ops)


@pytest.mark.parametrize("mode", ["continuous", "megakernel"])
def test_poisoned_dispatch_rolls_back_bitwise_clean(stream, mode):
    """A fault plan armed over the kernel seam poisons some dispatch
    outputs; the guard rolls the table back to the kept one, and the
    retried advance gives the fault-free bits.  The guarded megakernel
    writes a new table every launch (the unguarded one writes in place)."""
    clean, _ = _chaos_run(SU3Service(_config(ServiceConfig, BatcherConfig, mode),
                                     device="cpu"), stream)
    plan = _poison_plan(FaultPlan, FaultSpec)
    svc = SU3Service(_config(ServiceConfig, BatcherConfig, mode, faults=plan), device="cpu")
    assert svc._guarded
    chaotic, _ = _chaos_run(svc, stream)
    assert plan.fired > 0, "the plan must actually fire"
    assert svc.metrics.snapshot()["faults_injected"] == plan.fired
    for x, y in zip(chaotic, clean):
        assert not isinstance(x, RequestFailure), x
        assert torch.equal(x, y)
    if mode == "megakernel":
        table = svc._tables[0][1]
        before = table.a_phys
        table.advance([0] * table.slots)
        assert table.a_phys.data_ptr() != before.data_ptr()


def test_chaos_run_fault_log_and_results_match_reference(stream):
    """The same fault plan over the same stream fires the same faults, by
    (site, action, site_seq), on both services, and both recover to results
    that agree within tolerance."""
    tplan, jplan = _poison_plan(FaultPlan, FaultSpec), _poison_plan(JFaultPlan, JFaultSpec)
    tres, tsched = _chaos_run(SU3Service(
        _config(ServiceConfig, BatcherConfig, "megakernel", faults=tplan), device="cpu"), stream)
    jres, jsched = _chaos_run(JSU3Service(
        _config(JServiceConfig, JBatcherConfig, "megakernel", faults=jplan)), stream)
    key = lambda log: [(e["site"], e["action"], e["site_seq"]) for e in log]  # noqa: E731
    assert key(tplan.log()) == key(jplan.log()) and tplan.fired > 0
    assert tsched == jsched
    for got, want in zip(tres, jres):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL


def test_service_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SU3Service(_config(ServiceConfig, BatcherConfig, "batch"))
