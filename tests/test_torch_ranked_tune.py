"""The stencil and CG tuners on the ranks of a process group, on the CPU.

``best_stencil_config`` and ``best_cg_config`` at L=8 on 4 slabs run over 2
and 4 gloo ranks (``_torch_batch_workers.tune_rank``).  Every rank measures
its slabs of the ranked plan; a candidate's seconds are the slowest rank's
and its ``verified`` the AND over the ranks, so every rank returns the same
config.  Rank 0 alone reads the cache and writes it, once, under a key that
carries the world size; a second call is served from the cache on every
rank.  ``hosts=1`` at world 2 or 4 is refused before any measurement, and a
bitwise failure injected on rank 1 leaves the candidate unverified on every
rank, with no rank left waiting in a collective.

The model charges each rank its share of the sites, the ghost bytes that
cross to another rank at ``HardwareSpec.peer_bw`` and, for CG, the
reductions; without a group its predictions are the one card's, bit for
bit.
"""
import json

import pytest

import _torch_batch_workers as workers
from repro_torch.core import autotune, roofline
from repro_torch.core.su3 import plan as tplan
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

HOSTS, TUNE_L = 4, 8
WORLDS = [2, 4]
HW = roofline.H100_SXM


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"tune_w{world}")
        cache = d / "cache"
        cache.mkdir()
        workers.spawn_within(workers.tune_rank, world, 240, world, HOSTS, TUNE_L, str(cache),
                             str(d))
        out[world] = {"ranks": [json.loads((d / f"rank{r}.json").read_text())
                                for r in range(world)],
                      "cache": autotune.load_cache(str(cache))}
    return out


@pytest.mark.parametrize("tuner", ["stencil", "cg"])
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_config(ranks, world, tuner):
    res = ranks[world]["ranks"]
    first = [r[tuner]["first"] for r in res]
    assert all(f == first[0] for f in first) and not first[0]["cached"]
    prov = first[0]["stencil" if tuner == "stencil" else "cg"]
    assert prov["hosts"] == HOSTS and prov["schema"] == autotune.SCHEMA_VERSION
    # on 4 ranks of 4 slabs only tiles that pad nothing are candidates
    assert prov["candidates_total"] == (12 if tuner == "stencil" else 8)
    assert (TUNE_L**4) % (HOSTS * first[0]["tile"]) == 0
    for r in res:
        assert r[tuner]["second"] == dict(first[0], cached=True)
        assert r[tuner]["timed"] > 0 and r[tuner]["timed_again"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_the_cache_is_written_once_under_the_worlds_key(ranks, world):
    res, cache = ranks[world]["ranks"], ranks[world]["cache"]
    assert sorted(cache) == sorted(res[0]["writes"])
    assert len(cache) == 2 and all(f"|w{world}|L{TUNE_L}|" in k for k in cache)
    assert {k.split("|")[3] for k in cache} == {f"soa-stencil-h{HOSTS}", f"soa-cg-h{HOSTS}"}
    assert all(r["writes"] == [] for r in res[1:])  # rank 0 alone writes


@pytest.mark.parametrize("world", WORLDS)
def test_hosts_not_a_multiple_of_the_world_is_refused_before_measuring(ranks, world):
    for r in ranks[world]["ranks"]:
        assert "hosts=1" in r["hosts1"] and f"{world} ranks" in r["hosts1"]
        assert r["hosts1_timed"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_a_failure_on_one_rank_is_unverified_on_every_rank(ranks, world):
    res = ranks[world]["ranks"]
    for r in res:
        for tuner in ("stencil", "cg"):
            assert r["injected"][tuner] == res[0]["injected"][tuner]
            assert r["injected"][tuner]["verified"] is False
        assert r["injected_s"] < 60.0


# -- the model ---------------------------------------------------------------------------


def _one_card_stencil(cand, L, hosts):
    """The one-card stencil prediction as the model computed it before ranks."""
    n = L**4
    padded = ((n + cand.tile - 1) // cand.tile) * cand.tile
    cfg = tplan.EngineConfig(L=L, tile=cand.tile)
    kernel = roofline.stencil_bound(cfg, HW)
    split = cand.overlap and hosts > 1
    launches = (2.5 if cand.depth == 2 else 2.0) if split else 1.0
    issue_s = (float(autotune.stencil_ops_per_site()) * padded / (HW.peak_flops_fp32 / 2)
               + autotune.LAUNCH_OVERHEAD_S * launches)
    core_s = max(kernel.compute_s, kernel.memory_s, issue_s)
    halo = autotune._stencil_halo_spec(L, hosts, 4, depth=cand.depth)
    ex = autotune._exchange_bytes(halo, hosts, 1, cand.depth) if split else 0
    halo_s = autotune._exchange_seconds(ex, HW) / cand.depth if split else 0.0
    frac = halo.boundary_sites / halo.sites_per_shard if hosts > 1 else 0.0
    return max(core_s, halo_s) + cand.depth * frac * core_s if split else core_s


def _one_card_cg(cand, L, hosts):
    n = L**4
    padded = ((n + cand.tile - 1) // cand.tile) * cand.tile
    cfg = tplan.EngineConfig(L=L, tile=cand.tile)
    terms = roofline.cg_iteration_bound(cfg, HW)
    kernel, stream = terms["kernel"], terms["total"].bytes
    ops = autotune.stencil_ops_per_site(cg=True)
    if not cand.fused:
        kernel = roofline.stencil_bound(cfg, HW)
        stream = (terms["total"].bytes - terms["kernel"].bytes + kernel.bytes + 18 * 4 * n
                  - terms["gathers"].bytes / 2)
        ops = autotune.stencil_ops_per_site() + 12
    flops = float(autotune.su3_stencil.CG_ITER_FLOPS_PER_SITE) * n
    split = hosts > 1
    issue_s = float(ops) * padded / (HW.peak_flops_fp32 / 2) + autotune.LAUNCH_OVERHEAD_S * (
        2 if split else 1)
    core_s = max(flops / HW.peak_flops_fp32, stream / HW.hbm_bw, issue_s)
    halo = autotune._stencil_halo_spec(L, hosts, 4)
    ex = autotune._exchange_bytes(halo, hosts, 2 if cand.fused else 1, 1) if split else 0
    halo_s = autotune._exchange_seconds(ex, HW) if split else 0.0
    frac = halo.boundary_sites / halo.sites_per_shard if split else 0.0
    return max(core_s, halo_s) + frac * kernel.bound_s if split else core_s


STENCIL_CANDS = [autotune.StencilCandidate(t, o, d) for t in (64, 512) for o, d in
                 ((False, 1), (True, 1), (True, 2))]
CG_CANDS = [autotune.CGCandidate(t, f) for t in (64, 512) for f in (True, False)]


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_without_a_group_predictions_are_the_one_cards(hosts):
    for cand in STENCIL_CANDS:
        pred = autotune.predict_stencil(cand, 8, hosts=hosts, hw=HW)
        assert pred["bound_s"] == _one_card_stencil(cand, 8, hosts)
        assert pred["world"] is None and pred["peer_bytes"] == 0.0
    for cand in CG_CANDS:
        pred = autotune.predict_cg(cand, 8, hosts=hosts, hw=HW)
        assert pred["bound_s"] == _one_card_cg(cand, 8, hosts) and pred["reduce_s"] == 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_bytes_that_leave_the_rank_go_at_the_peer_rate(world):
    hosts, L = 4, 8
    cand = autotune.StencilCandidate(128, True, 1)
    pred = autotune.predict_stencil(cand, L, hosts=hosts, hw=HW, world=world)
    halo = autotune._stencil_halo_spec(L, hosts, 4)
    ex = autotune._exchange_bytes(halo, hosts, 1, 1)
    assert ex == 2 * (2 * hosts * halo.boundary_sites) * 6 * 4
    cross = world / hosts  # of the 2 * hosts face transfers, the 2 * world between ranks
    card, peer = (1 - cross) * ex / world, cross * (ex / 2) / world
    assert pred["peer_bytes"] == peer
    assert pred["halo_s"] == pytest.approx(autotune.HALO_EXCHANGE_LATENCY_S + card / HW.hbm_bw
                                           + peer / HW.peer_bw, rel=1e-12)
    # each rank runs its share of the sites
    one = autotune.predict_stencil(cand, L, hosts=hosts, hw=HW)
    assert pred["memory_s"] == pytest.approx(one["memory_s"] / world, rel=1e-12)
    # depth 2 also sends the links of the ring sites another rank owns
    deep = autotune.predict_stencil(autotune.StencilCandidate(128, True, 2), L, hosts=hosts,
                                    hw=HW, world=world)
    ex2 = autotune._exchange_bytes(autotune._stencil_halo_spec(L, hosts, 4, depth=2), hosts,
                                   1, 2)
    ghosts = 2 * hosts * halo.boundary_sites
    assert deep["peer_bytes"] == pytest.approx(cross * (ex2 / 2 + ghosts * 72 * 4) / world)
    # CG: r and p cross, and the two reductions are charged per iteration
    cg = autotune.predict_cg(autotune.CGCandidate(128, True), L, hosts=hosts, hw=HW, world=world)
    ex_cg = autotune._exchange_bytes(halo, hosts, 2, 1)
    assert cg["peer_bytes"] == cross * (ex_cg / 2) / world
    assert cg["reduce_s"] == autotune.CG_REDUCTION_LATENCY_S
    # a slower peer link only slows the exchange
    slow = roofline.HardwareSpec("slow", HW.peak_flops_fp32, HW.hbm_bw, HW.hbm_bytes,
                                 HW.peak_flops_bf16, peer_bw=HW.peer_bw / 100)
    slowed = autotune.predict_stencil(cand, L, hosts=hosts, hw=slow, world=world)
    assert slowed["halo_s"] > pred["halo_s"] and slowed["core_s"] == pred["core_s"]


def test_one_rank_sends_nothing_across_ranks():
    cand = autotune.StencilCandidate(128, True, 1)
    one = autotune.predict_stencil(cand, 8, hosts=2, hw=HW, world=1)
    assert one["peer_bytes"] == 0.0
    assert one["bound_s"] == pytest.approx(autotune.predict_stencil(cand, 8, hosts=2,
                                                                    hw=HW)["bound_s"])
    cg = autotune.predict_cg(autotune.CGCandidate(128, True), 8, hosts=2, hw=HW, world=1)
    base = autotune.predict_cg(autotune.CGCandidate(128, True), 8, hosts=2, hw=HW)
    assert cg["bound_s"] == pytest.approx(base["bound_s"] + autotune.CG_REDUCTION_LATENCY_S)


def test_peer_rates_from_the_datasheet():
    assert roofline.H100_SXM.peer_bw == 450e9  # NVLink 900 GB/s in total
    assert roofline.H100_PCIE.peer_bw == 64e9  # PCIe Gen5 x16, no bridge


def test_cache_keys_carry_the_world_of_a_group_only():
    kw = dict(backend="cuda", device_kind="x", layout="soa-cg-h4", dtype="float32", L=8,
              n_devices=1)
    assert autotune.SCHEMA_VERSION == 2
    # without a group: the key of schema 1 but for its prefix
    assert autotune.cache_key(**kw) == "v2|cuda|x|soa-cg-h4|float32|none|L8|d1"
    assert autotune.cache_key(**kw, world=4) == "v2|cuda|x|soa-cg-h4|float32|none|w4|L8|d1"
    assert autotune.cache_key(**kw, world=1).endswith("|none|w1|L8|d1")  # one rank of a group
    assert "|w" not in autotune._keyed("soa-stencil-h2", 8, "float32", "", "none", "cpu")
