"""The framework-free serving pieces of the PyTorch port against the JAX
package's: tenancy, robustness, the batcher, the metrics, the bounded
statistics, the tracer and the fault plan.

These modules hold host-side scheduling state only, so the port carries
copies of them.  Each test drives the same scripted sequence through both
packages' objects and requires the same decisions: the fair scheduler's
order, the brownout ladder's ``(turn, from, to)`` signature, the fault
plan's log, the reservoir's samples for a seed, the batcher's coalescing
and slot bookkeeping, the metrics snapshot.  No tolerance applies: the
results are equal or the test fails.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import faults as jfaults
from repro.obs import stats as jstats
from repro.obs import tracer as jtracer
from repro.serve.su3 import batcher as jbatcher
from repro.serve.su3 import metrics as jmetrics
from repro.serve.su3 import robustness as jrobust
from repro.serve.su3 import tenancy as jtenancy
from repro_torch.chaos import faults as tfaults
from repro_torch.obs import stats as tstats
from repro_torch.obs import tracer as ttracer
from repro_torch.serve.su3 import batcher as tbatcher
from repro_torch.serve.su3 import metrics as tmetrics
from repro_torch.serve.su3 import robustness as trobust
from repro_torch.serve.su3 import tenancy as ttenancy

BULK, LAT = "bulk", "latency"


# -- tenancy ---------------------------------------------------------------------


def _fair_order(ten, steps: int = 300) -> tuple[list, dict]:
    """Drive a DeficitFairScheduler through a churning pending set: groups
    come and go, weights differ by class and tenant."""
    pol = ten.SLOPolicy(latency_weight=4.0, bulk_weight=1.0)
    weights = {("heavy", BULK): 3.0}
    sched = ten.DeficitFairScheduler(
        weight_for=lambda g: weights.get(g, pol.weight_for(g)), quantum=0.5)
    groups = [("a", BULK), ("a", LAT), ("b", BULK), ("heavy", BULK), ("drip", BULK)]
    rng = random.Random(5)
    order = []
    for i in range(steps):
        pending = [g for g in groups if rng.random() < 0.7 or g == ("a", BULK)]
        if i % 50 == 49:
            pending = []  # an idle turn
        order.append(sched.next_group(pending))
    return order, dict(sched.turns)


def test_fair_scheduler_order_matches_reference():
    order, turns = _fair_order(ttenancy)
    assert (order, turns) == _fair_order(jtenancy)
    assert None in order and len(set(g for g in order if g)) == 5


def _brownout_run(ten):
    cfg = ten.BrownoutConfig(enter_pressure=0.8, exit_pressure=0.3, sustain_turns=2,
                             exit_turns=3)
    lad = ten.BrownoutLadder(cfg)
    rng = np.random.default_rng(3)
    trace = np.concatenate([rng.uniform(0.7, 1.0, 40), rng.uniform(0.0, 0.5, 30),
                            rng.uniform(0.2, 0.95, 60)])
    moves = [lad.observe(float(p)) for p in trace]
    return moves, lad.signature(), lad.rung


def test_brownout_signature_matches_reference():
    moves, sig, rung = _brownout_run(ttenancy)
    assert (moves, sig, rung) == _brownout_run(jtenancy)
    assert sig and all(isinstance(t, int) for t, _f, _to in sig)


def _autoscale_run(ten):
    cfg = ten.AutoscaleConfig(enabled=True, min_hosts=1, grow_queue_depth=4,
                              grow_occupancy=0.9, shrink_queue_depth=1,
                              shrink_occupancy=0.25, grow_turns=2, shrink_turns=3)
    sc = ten.WarmPoolAutoscaler(cfg, max_hosts=3)
    active, out = 1, []
    rng = random.Random(9)
    for _ in range(120):
        d = sc.observe(depth_per_host=rng.choice([0, 0, 2, 8]),
                       occupancy=rng.choice([0.0, 0.5, 1.0]), active=active)
        active += d
        out.append((d, active))
    return out


def test_autoscaler_decisions_match_reference():
    out = _autoscale_run(ttenancy)
    assert out == _autoscale_run(jtenancy)
    assert {d for d, _a in out} == {-1, 0, 1}


def test_token_bucket_matches_reference():
    def run(ten):
        bucket = ten.TokenBucket(ten.TenantQuota(rate_per_s=20.0, burst=3))
        return [bucket.try_take(now) for now in np.linspace(0.0, 1.0, 80)]

    assert run(ttenancy) == run(jtenancy)


# -- robustness ------------------------------------------------------------------


def test_retry_policy_schedule_matches_reference():
    def run(rob):
        pol = rob.RetryPolicy(max_retries=5, base_s=0.001, cap_s=0.02, jitter=0.3, seed=4)
        rng = random.Random(pol.seed)
        return [pol.backoff_s(a, rng) for a in range(1, 9)]

    assert run(trobust) == run(jrobust)
    with pytest.raises(ValueError, match="jitter"):
        trobust.RetryPolicy(jitter=2.0)


def test_host_health_matches_reference():
    def run(rob):
        h = rob.HostHealth(3, quarantine_after=2)
        rng = random.Random(2)
        out = []
        for _ in range(60):
            host = rng.randrange(3)
            if rng.random() < 0.6:
                out.append(("fail", host, h.record_failure(host, "x")))
            else:
                h.record_success(host)
            if rng.random() < 0.05 and h.quarantined():
                h.reinstate(sorted(h.quarantined())[0])
            out.append(sorted(h.quarantined()))
        return out, h.snapshot()

    assert run(trobust) == run(jrobust)


def test_structured_failures_match_reference():
    def errors(mod):
        return [
            mod.DeadlineExceededError(req_id=1, kind="solve", deadline_s=0.5, waited_s=0.7,
                                      attempts=1, partial=None),
            mod.RetriesExhaustedError(req_id=2, kind="multiply", attempts=3, cause="c",
                                      budget_exhausted=True),
            mod.LoadShedError(req_id=3, kind="stencil", priority=1, shed_for_kind="brownout",
                              retry_after_s=0.25),
        ]

    for t, j in zip(errors(trobust), errors(jrobust)):
        assert str(t) == str(j) and type(t).__name__ == type(j).__name__
        assert isinstance(t, trobust.RequestFailure)
    assert trobust.PRIORITY == jrobust.PRIORITY


# -- the batcher -----------------------------------------------------------------


def _req(bat, i, L=2, k=1, kind="multiply", tenant="default", slo=BULK, deadline=0.0,
         priority=None):
    return bat.ServeRequest(req_id=i, a=None, b=None, L=L, k=k, arrival_s=float(i + 1),
                            kind=kind, tenant=tenant, slo=slo, deadline_s=deadline,
                            priority=trobust.PRIORITY[kind] if priority is None else priority)


def _batcher_run(bat):
    b = bat.DynamicBatcher(bat.BatcherConfig(max_batch=4, warm_batch_sizes=(1, 2, 4),
                                             max_queue_depth=12))
    rng = random.Random(11)
    log = []
    for i in range(40):
        kind = rng.choice(["multiply", "multiply", "stencil", "solve"])
        req = _req(bat, i, L=rng.choice([2, 3]), k=rng.choice([1, 2]), kind=kind,
                   tenant=rng.choice(["t0", "t1"]), slo=rng.choice([BULK, LAT]),
                   deadline=rng.choice([0.0, 0.0, 20.0]))
        ok = b.submit(req)
        if not ok:
            victim = b.shed_lowest(req.priority, sheddable_slo=BULK)
            log.append(("shed", None if victim is None else victim.req_id))
        log.append(("submit", i, ok, len(b)))
        if i % 3 == 2:
            g = sorted(b.pending_kinds_by_group())
            group = g[0] if g else None
            batch = b.next_batch(group=group)
            log.append(("batch", None if batch is None else
                        (batch.key, [r.req_id for r in batch.requests], batch.padded_size)))
            st = b.next_stencil_batch()
            log.append(("stencil", None if st is None else [r.req_id for r in st.requests]))
            so = b.next_solve()
            log.append(("solve", None if so is None else so.req_id))
            log.append(("for_L", [r.req_id for r in b.next_for_L(2, 2)]))
        if i == 25:
            log.append(("expired", [r.req_id for r in b.evict_expired(21.5)]))
    log.append(("depths", b.bucket_depths(), b.stencil_depths(), b.solve_depths(),
                b.queued_Ls(), b.depth_for_slo(BULK)))
    log.append(("drain", [r.req_id for r in b.drain()]))
    return log


def test_batcher_decisions_match_reference():
    log = _batcher_run(tbatcher)
    assert log == _batcher_run(jbatcher)
    assert any(e[0] == "batch" and e[1] for e in log)


def _slots_run(bat):
    log = []
    chain = bat.InflightChain(L=2, slots=3)
    for i in range(3):
        log.append(chain.admit(_req(bat, i, k=i + 1)))
    log.append([(s, r.req_id) for s, r in chain.advance()])
    log.append(chain.midchain)
    log.append(chain.evict(1).req_id)
    log.append(chain.admit(_req(bat, 3, k=2)))
    for _ in range(3):
        log.append([(s, r.req_id) for s, r in chain.advance()])
    table = bat.SlotTable(slots=4)
    for i, (L, k) in enumerate([(2, 5), (3, 1), (2, 3)]):
        log.append(table.admit(_req(bat, 10 + i, L=L, k=k)))
    for horizon in (2, 1, 4, 4):
        ks = table.plan_k(horizon)
        log.append((ks, [(s, r.req_id) for s, r in table.advance(ks)], table.max_live_L))
        if table.can_admit:
            log.append(table.admit(_req(bat, 20 + horizon, L=3, k=2)))
    log.append([(s, r.req_id, rem) for s, r, rem in table.occupants()])
    router = bat.LocalityRouter(3)
    for L in (2, 3, 2, 4, 5, 3):
        host = router.host_for(L)
        router.record_load(host, float(L**4))
        log.append(host)
    log.append((router.assignments(), router.loads()))
    return log


def test_chain_slot_table_and_router_match_reference():
    assert _slots_run(tbatcher) == _slots_run(jbatcher)


# -- metrics, statistics, tracer ---------------------------------------------------


def _metrics_run(met):
    m = met.ServiceMetrics()
    rng = random.Random(6)
    for i in range(300):
        m.record_admit(rng.randrange(10), tenant=rng.choice(["t0", "t1"]),
                       slo=rng.choice([BULK, LAT]))
        m.record_dispatch(live=rng.randrange(1, 5), padded=4, step_s=rng.random() * 1e-3,
                          flops=met.request_flops(16, rng.randrange(1, 4)),
                          cold=i < 3, host=rng.randrange(2))
        m.record_iteration(rng.randrange(2), kind=rng.choice(["multiply", "solve"]),
                           n=rng.randrange(1, 4))
        m.record_completion(rng.random() * 1e-2, tenant="t0", slo=BULK)
        m.record_queue_depth(rng.randrange(8))
        if i % 7 == 0:
            m.record_shed("multiply", for_kind="solve", tenant="t1", slo=BULK)
            m.record_timeout("stencil", tenant="t0", slo=LAT)
            m.record_retry()
            m.record_midchain_admits(2)
    snap = m.snapshot()
    for key in [k for k in snap if "wall" in k]:
        snap.pop(key)  # read from the clock
    return snap


def test_metrics_snapshot_matches_reference():
    t, j = _metrics_run(tmetrics), _metrics_run(jmetrics)
    assert t.keys() == j.keys()
    assert t == j


def test_reservoir_samples_match_reference_for_a_seed():
    for seed in (0, 7):
        tr, jr = tstats.Reservoir(capacity=64, seed=seed), jstats.Reservoir(capacity=64, seed=seed)
        values = np.random.default_rng(seed).exponential(size=5000).tolist()
        tr.extend(values)
        jr.extend(values)
        assert tr.sample == jr.sample and len(tr) == len(jr) == 5000
        assert tr.percentile(99) == jr.percentile(99) and tr.mean() == jr.mean()
    ts, js = tstats.RunningStat(), jstats.RunningStat()
    for v in (3.0, 1.0, 2.5):
        ts.add(v)
        js.add(v)
    assert (ts.mean(), ts.max_or(0)) == (js.mean(), js.max_or(0))


def _trace_run(tr):
    t = tr.Tracer(capacity=8)
    for i in range(12):
        t.add_span("dispatch", 1.0 + i, 1.5 + i, lane=i % 2, host=i % 2, k=i)
    t.event("admit", lane=3, req_id=4)
    t.count("fault", 2)
    recs = list(t.iter_records())
    for r in recs:
        if r["name"] == "admit":
            r.pop("ts_s")  # an event reads the clock
    chrome = t.chrome_trace(metadata={"run": "x"})
    events = [e for e in chrome["traceEvents"] if e.get("name") == "dispatch"]
    return recs, t.dropped, len(t), events


def test_tracer_records_and_exports_match_reference():
    assert _trace_run(ttracer) == _trace_run(jtracer)
    assert ttracer.NULL_TRACER.enabled is False


# -- the fault plan ----------------------------------------------------------------


def _fault_run(fm):
    sites = {
        "dispatch": fm.FaultSpec(probability=0.4, actions=("fail", "delay"), after=2),
        "kernel": fm.FaultSpec(probability=0.3, actions=("nan", "inf"), max_fires=5),
        "pool": fm.FaultSpec(probability=0.2, actions=("fail",)),
    }
    plan = fm.FaultPlan(13, sites)
    rng = random.Random(1)
    for _ in range(200):
        plan.ask(rng.choice(["dispatch", "kernel", "pool"]), host=rng.randrange(2))
    storm = fm.storm(5, dispatch_p=0.1, kernel_p=0.2, after=3)
    for site in ("dispatch", "kernel") * 30:
        storm.ask(site)
    return plan.log(), plan.describe(), storm.log(), storm.reset().describe()


def test_fault_plan_log_matches_reference():
    t, j = _fault_run(tfaults), _fault_run(jfaults)
    assert t == j
    key = lambda log: [(e["site"], e["action"], e["site_seq"]) for e in log]  # noqa: E731
    assert key(t[0]) == key(j[0]) and len(t[0]) > 0
    assert tfaults.SITES == jfaults.SITES and tfaults.SITE_ACTIONS == jfaults.SITE_ACTIONS


@pytest.mark.parametrize("action", ["nan", "inf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poison_array_returns_a_new_tensor_poisoned_as_the_reference(action, dtype):
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4).to(dtype)
    before = x.clone()
    out = tfaults.poison_array(x, action)
    assert torch.equal(x, before)  # the input is never written: rollback holds
    assert out.data_ptr() != x.data_ptr() and out.shape == x.shape and out.dtype == dtype
    want = np.asarray(jfaults.poison_array(jnp.asarray(before.float().numpy()), action))
    np.testing.assert_array_equal(out.float().numpy(), want)
    # a non-contiguous view poisons its own first element, not its storage's
    view = x.transpose(0, 2)
    assert torch.isnan(tfaults.poison_array(view, "nan")[0, 0, 0]) or action == "inf"
    assert torch.equal(x, before)
