"""The slot-batched megakernel and the megakernel service mode of the PyTorch
port against the JAX reference (``tests/test_megakernel.py``, mirrored).

The same numpy inputs (random SU(3) links from a seed) go through the JAX
plan's ``fused_batched_step`` (Pallas in interpret mode) and the port's on
the CPU, where the CUDA kernel runs its plain version.  Tolerance is the
reference's ``verify_tolerance``: XLA contracts FMAs at f32 and under f32
accumulation, so there the frameworks agree within it; pure bf16 rounds
after every operation on both sides and agrees bit for bit.  Inside the
port the contracts are bitwise: slot_k in {0, 1} equals the single step
(dead slots untouched), a deep chain equals that many single steps (both
kernels run one chain body) and, under f32 accumulation, the fused chain.

Each JAX result is computed once per module.  The CUDA kernel itself is
held against its plain version in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.su3 import plan as jplan
from repro.core.su3.layouts import Layout as JLayout
from repro.serve.su3 import BatcherConfig as JBatcherConfig
from repro.serve.su3 import ServiceConfig as JServiceConfig
from repro.serve.su3 import SU3Service as JSU3Service
from repro_torch.core.su3 import registry
from repro_torch.core.su3.layouts import Layout
from repro_torch.core.su3.plan import (
    MEGAKERNEL_VARIANT,
    EngineConfig,
    build_plan,
    make_raw_batched_step,
    make_raw_step,
    verify_tolerance,
)
from repro_torch.kernels import su3_matmul
from repro_torch.serve.su3 import BatcherConfig, ServiceConfig, SU3Service

SLOTS = 4

ALL_PLANS = [
    ("soa", "float32", ""),
    ("aosoa", "float32", ""),
    ("soa", "bfloat16", ""),
    ("aosoa", "bfloat16", ""),
    ("soa", "bfloat16", "float32"),
    ("aosoa", "bfloat16", "float32"),
]
SHALLOW = [0, 1, 1, 0]  # the serving iteration granularity
DEEP = [1, 2, 3, 4]


def _su3(n_sites: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_sites, 4, 3, 3)) + 1j * rng.standard_normal((n_sites, 4, 3, 3))
    q, r = np.linalg.qr(g)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)).astype(np.complex64)


def _np(x) -> np.ndarray:
    """jax array or torch tensor -> numpy (bf16 words as f32 values)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jax.device_get(x)
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _plans(layout: str, dtype: str, accum: str, L: int = 2):
    fields = dict(L=L, dtype=dtype, tile=16, accum_dtype=accum)
    jp = jplan.build_plan(jplan.EngineConfig(layout=JLayout(layout), **fields))
    tp = build_plan(EngineConfig(layout=Layout(layout), **fields), device="cpu")
    return jp, tp


def _tables(jp, tp, slots: int = SLOTS, seed: int = 0):
    """One slot table of random SU(3) lattices, packed by each package's
    codec from the same numpy data."""
    a = _su3(slots * tp.padded_sites, seed).reshape(slots, tp.padded_sites, 4, 3, 3)
    b = _su3(slots, seed + 1)
    ja = jax.vmap(jp.codec.pack)(jnp.asarray(a))
    jb = jax.vmap(jp.codec.pack_b)(jnp.asarray(b))
    ta = torch.stack([tp.codec.pack(torch.from_numpy(x)) for x in a]).contiguous()
    tb = torch.stack([tp.codec.pack_b(torch.from_numpy(x)) for x in b]).contiguous()
    np.testing.assert_array_equal(_np(ta), _np(ja))  # the same words on both sides
    return ja, jb, ta, tb


@pytest.fixture(scope="module")
def batched():
    """Per plan: both packages' tables and the JAX megakernel at SHALLOW
    and DEEP depths (one interpret-mode program per plan)."""
    out = {}
    for layout, dtype, accum in ALL_PLANS:
        jp, tp = _plans(layout, dtype, accum)
        ja, jb, ta, tb = _tables(jp, tp)
        step = jp.fused_batched_step(SLOTS, max_k=4)
        out[(layout, dtype, accum)] = {
            "tp": tp, "ta": ta, "tb": tb,
            "jax": {tuple(ks): _np(step(ja, jb, jnp.asarray(ks, jnp.int32)))
                    for ks in (SHALLOW, DEEP)},
        }
    return out


def _check_against_jax(got: torch.Tensor, want: np.ndarray, dtype: str, accum: str) -> None:
    if dtype == "bfloat16" and not accum:  # pure bf16: both round every operation
        np.testing.assert_array_equal(_np(got), want)
    else:
        tol = verify_tolerance(dtype, accum)
        assert float(np.max(np.abs(_np(got) - want))) <= tol


@pytest.mark.parametrize("layout,dtype,accum", ALL_PLANS)
def test_iteration_granularity_bit_identical_to_single_step(batched, layout, dtype, accum):
    """slot_k in {0,1} — what continuous serving dispatches — equals the
    chained single-step path bit for bit, dead slots passing through, and
    the JAX megakernel within tolerance."""
    d = batched[(layout, dtype, accum)]
    tp, ta, tb = d["tp"], d["ta"], d["tb"]
    c = tp.fused_batched_step(SLOTS, max_k=4)(ta, tb, torch.tensor(SHALLOW, dtype=torch.int32))
    ref = torch.stack([tp.step(ta[s], tb[s]) if SHALLOW[s] else ta[s] for s in range(SLOTS)])
    assert c.dtype == ref.dtype and torch.equal(c, ref)
    _check_against_jax(c, d["jax"][tuple(SHALLOW)], dtype, accum)


@pytest.mark.parametrize("layout,dtype", [
    ("soa", "float32"), ("aosoa", "float32"), ("soa", "bfloat16"), ("aosoa", "bfloat16"),
])
def test_deep_chains_pure_dtype_bit_identical_to_sequential_steps(batched, layout, dtype):
    d = batched[(layout, dtype, "")]
    tp, ta, tb = d["tp"], d["ta"], d["tb"]
    c = tp.fused_batched_step(SLOTS, max_k=4)(ta, tb, torch.tensor(DEEP, dtype=torch.int32))
    ref = []
    for s in range(SLOTS):
        x = ta[s]
        for _ in range(DEEP[s]):
            x = tp.step(x, tb[s])
        ref.append(x)
    assert torch.equal(c, torch.stack(ref))
    _check_against_jax(c, d["jax"][tuple(DEEP)], dtype, "")


@pytest.mark.parametrize("layout", ["soa", "aosoa"])
def test_deep_chains_mixed_precision_bit_identical_to_fused_step(batched, layout):
    d = batched[(layout, "bfloat16", "float32")]
    tp, ta, tb = d["tp"], d["ta"], d["tb"]
    c = tp.fused_batched_step(SLOTS, max_k=4)(ta, tb, torch.tensor(DEEP, dtype=torch.int32))
    ref = torch.stack([tp.fused_step(DEEP[s])(ta[s], tb[s]) for s in range(SLOTS)])
    assert torch.equal(c, ref)
    _check_against_jax(c, d["jax"][tuple(DEEP)], "bfloat16", "float32")


def test_slot_k_clamped_to_static_max():
    jp, tp = _plans("soa", "float32", "")
    ja, jb, ta, tb = _tables(jp, tp, slots=2, seed=3)
    step = tp.fused_batched_step(2, max_k=2)
    c = step(ta, tb, torch.tensor([5, 2], dtype=torch.int32))
    assert torch.equal(c, step(ta, tb, torch.tensor([2, 2], dtype=torch.int32)))
    # a negative depth clamps to 0: the slot passes through
    neg = step(ta, tb, torch.tensor([-3, 1], dtype=torch.int32))
    assert torch.equal(neg[0], ta[0])
    jc = jp.fused_batched_step(2, max_k=2)(ja, jb, jnp.asarray([5, 2], jnp.int32))
    _check_against_jax(c, _np(jc), "float32", "")


def test_batched_kernel_is_registered_and_gated():
    entry = registry.get_kernel(MEGAKERNEL_VARIANT)
    assert registry.get_kernel("pallas_megakernel") is entry  # the reference's name
    assert entry.form == registry.BATCHED and entry.backends == ("cuda",)
    assert entry.supports_fused and entry.supports_accum and entry.supports_compressed
    assert MEGAKERNEL_VARIANT in registry.kernel_names(form=registry.BATCHED)
    codec = _plans("soa", "float32", "")[1].codec
    # a batched kernel cannot be a plan's single-lattice step...
    with pytest.raises(ValueError, match="fused_batched_step"):
        make_raw_step(codec, entry, tile=16)
    # ...and the batched step builder rejects non-batched kernels
    with pytest.raises(ValueError, match="batched"):
        make_raw_batched_step(codec, registry.get_kernel("cuda"), tile=16, max_k=2)
    aos = build_plan(EngineConfig(L=2, tile=16, layout=Layout.AOS, variant="versionX"),
                     device="cpu").codec
    with pytest.raises(ValueError, match="does not support layout"):
        make_raw_batched_step(aos, entry, tile=16, max_k=2)


def test_fused_batched_step_rejects_bad_args():
    tp = _plans("soa", "float32", "")[1]
    with pytest.raises(ValueError, match="slots"):
        tp.fused_batched_step(0)
    with pytest.raises(ValueError, match="max_k"):
        tp.fused_batched_step(2, max_k=0)
    # the wrapper checks the table against b and slot_k
    a = torch.zeros((2, 2, 36, 16))
    with pytest.raises(ValueError, match="slot_k"):
        su3_matmul.su3_mult_planar_batched(a, torch.zeros((2, 2, 36)),
                                           torch.zeros(3, dtype=torch.int32), tile=16)
    with pytest.raises(ValueError, match="b must be"):
        su3_matmul.su3_mult_planar_batched(a, torch.zeros((3, 2, 36)),
                                           torch.zeros(2, dtype=torch.int32), tile=16)


# -- service slot-table dispatch ----------------------------------------------


def _mega_config(cls_cfg, cls_batcher, slots=4, horizon=1, hosts=1):
    return cls_cfg(
        autotune=False, tile=16, continuous=True, megakernel=True,
        chain_slots=slots, chain_horizon=horizon, hosts=hosts,
        batcher=cls_batcher(max_batch=slots, warm_batch_sizes=(slots,), max_queue_depth=64),
    )


def _services(**kw):
    return (JSU3Service(_mega_config(JServiceConfig, JBatcherConfig, **kw)),
            SU3Service(_mega_config(ServiceConfig, BatcherConfig, **kw), device="cpu"))


def _drive(svc, stream, submit_between=None):
    """Submit ``stream`` [(a, b, k), ...] (numpy complex64), drain, and
    return the results by request id plus the metrics snapshot."""
    jax_side = isinstance(svc, JSU3Service)
    conv = jnp.asarray if jax_side else torch.from_numpy
    ids = [svc.submit(conv(a), conv(b), k=k) for a, b, k in stream]
    svc.run_until_drained()
    return [np.asarray(svc.pop_result(i)) for i in ids], svc.metrics.snapshot()


def _requests(seed: int, shape: list[tuple[int, int]]):
    return [(_su3(L**4, seed + i), _su3(1, seed + 100 + i)[0], k)
            for i, (L, k) in enumerate(shape)]


def _chain_ref(a, b, k):
    x = a.astype(np.complex128)
    for _ in range(k):
        x = np.einsum("sjkl,jlm->sjkm", x, b)
    return x


def _assert_results(got, want, tol=1e-5):
    for g, w in zip(got, want):
        assert float(np.max(np.abs(g - w))) <= tol


def test_megakernel_requires_continuous():
    with pytest.raises(ValueError, match="continuous"):
        ServiceConfig(megakernel=True)
    with pytest.raises(ValueError, match="chain_horizon"):
        ServiceConfig(continuous=True, megakernel=True, chain_horizon=0)


def test_one_dispatch_per_host_per_iteration_mixed_L():
    """Mixed lattice sizes and chain depths in flight, yet every iteration
    costs exactly ONE megakernel launch on the host; the port's results and
    counts equal the reference's."""
    stream = _requests(10, [(2, 1), (2, 3), (3, 2), (2, 2), (3, 1)])
    jsvc, tsvc = _services(slots=4)
    jres, jsnap = _drive(jsvc, stream)
    tres, tsnap = _drive(tsvc, stream)
    assert tsnap["completed"] == len(stream)
    assert tsnap["dispatches_per_iteration"] == 1.0
    assert tsnap["host_dispatches"] == {"0": tsnap["dispatches"]}
    assert tsnap["midchain_admits"] >= 1  # the 5th request slot-swapped in
    for key in ("completed", "dispatches", "iterations", "midchain_admits", "host_dispatches"):
        assert tsnap[key] == jsnap[key], key
    _assert_results(tres, jres)
    _assert_results(tres, [_chain_ref(a, b, k) for a, b, k in stream])


def test_slot_table_grows_for_larger_L_preserving_inflight_state():
    """A bigger lattice arriving mid-flight grows the table capacity; live
    slots re-seat at their mid-chain state and finish correctly."""
    (a2, b2, _), (a3, b3, _) = _requests(20, [(2, 3), (3, 1)])
    out = {}
    for svc in _services(slots=3):
        jax_side = isinstance(svc, JSU3Service)
        conv = jnp.asarray if jax_side else torch.from_numpy
        rid2 = svc.submit(conv(a2), conv(b2), k=3)
        assert svc.step() == 0  # L=2 chain in flight, 2 multiplies to go
        cap_before = svc._tables[0][1].cap_L
        rid3 = svc.submit(conv(a3), conv(b3), k=1)
        svc.run_until_drained()
        assert svc._tables[0][1].cap_L == 3 and cap_before == 2
        out[jax_side] = [np.asarray(svc.pop_result(rid2)), np.asarray(svc.pop_result(rid3))]
    _assert_results(out[False], out[True])
    _assert_results(out[False], [_chain_ref(a2, b2, 3), _chain_ref(a3, b3, 1)])


def test_chain_horizon_amortizes_dispatches():
    """horizon=4 finishes a k=4 request in ONE launch where horizon=1 takes
    four, with the same bits (one chain body either way)."""
    stream = _requests(30, [(2, 4)])
    one, snap1 = _drive(_services(slots=2, horizon=1)[1], stream)
    jsvc4, tsvc4 = _services(slots=2, horizon=4)
    four, snap4 = _drive(tsvc4, stream)
    jfour, jsnap4 = _drive(jsvc4, stream)
    assert snap1["dispatches"] == 4 and snap4["dispatches"] == jsnap4["dispatches"] == 1
    np.testing.assert_array_equal(one[0], four[0])
    _assert_results(four, jfour)


def test_megakernel_multihost_routes_and_dispatches_per_host():
    stream = _requests(40, [(2, 2), (3, 2)])  # the router pins each L to its own host
    jsvc, tsvc = _services(slots=2, hosts=2)
    jres, jsnap = _drive(jsvc, stream)
    tres, tsnap = _drive(tsvc, stream)
    assert set(tsnap["host_dispatches"]) == {"0", "1"}
    assert tsnap["host_dispatches"] == jsnap["host_dispatches"]
    _assert_results(tres, jres)


def test_megakernel_warm_compiles_the_table_shape():
    jsvc, tsvc = _services(slots=2)
    tsvc.warm((2,))
    assert ("mega", 2, 2, 1) in tsvc._seen_shapes
    jsvc.warm((2,))
    assert tsvc._seen_shapes == jsvc._seen_shapes
    stream = _requests(50, [(2, 1)])
    tres, tsnap = _drive(tsvc, stream)
    assert tsnap["compiles"] == 0, "a warmed table shape is not cold"
    _assert_results(tres, [_chain_ref(a, b, k) for a, b, k in stream])
