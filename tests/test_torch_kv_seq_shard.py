"""Decode on caches split along their sequence, the reference's
``kv_seq_shard``: ``ServeEngine(..., mesh=, kv_seq_shard=True)`` places every
cache whose kv heads do not divide the model axis along its sequence
(``state_placements``), prefill and decode write each rank's own rows
(``attention.write_cache``), and decode combines each rank's partial
softmax over its keys (``attention.decode_partial``,
``combine_partials``; MLA's absorbed decode on its latents alike).

Served, prefill and 4 greedy decode steps (f32 weights and caches):
granite-34b reduced (MQA: one kv head) and deepseek-v3 reduced (MLA's
latents) on (2, 2), whisper-tiny reduced with its own 6 heads (which do not
divide 4: self and cross caches along S and F) on (1, 4).  Held against
the reference's jitted ``prefill`` and ``decode_step`` with
``state_shardings(..., kv_seq_shard=True)`` on its forced CPU mesh of the
same shape and against the port's one process: last-position logits
within 1e-4 of their max, the greedy tokens equal; every cache leaf at the
reference's spec, holding only its shard.  On a (1, 1) mesh the latents
are still split, into one part, whose weight in the combine is exactly 1:
bitwise the one process.

The combine alone: within 1e-5 (f32) of the unsplit ``decode_attention``
for 1, 2 and 4 parts, one of them wholly past ``cur_len`` (its weight 0),
bitwise with one part, and the same bits twice.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_family_checks as checks
import _torch_mesh_family_workers as fw
import _torch_mesh_workers as workers
from repro_torch.models import attention
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

SERVED = {"granite-34b": (2, 2), "deepseek-v3-671b": (2, 2), "whisper-tiny-6h": (1, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each arch's runs (``checks.family_runs``, serving only), by arch."""
    out = {}
    for shape in sorted(set(SERVED.values())):
        archs = [a for a, s in SERVED.items() if s == shape]
        d = tmp_path_factory.mktemp("kv_seq_shard_" + "x".join(map(str, shape)))
        found = checks.family_runs(d, archs, train=False, serve_shapes=(shape,),
                                   kv_seq_shard=True)
        out.update({a: found for a in archs})
    return out


@pytest.mark.parametrize("arch", list(SERVED))
def test_seq_sharded_serving_matches_the_reference(runs, arch):
    checks.test_mesh_serving_matches_the_reference(runs[arch], arch, SERVED[arch])


@pytest.mark.parametrize("arch", list(SERVED))
def test_seq_sharded_serving_matches_the_one_process(runs, arch):
    checks.test_mesh_serving_matches_the_one_process(runs[arch], arch, SERVED[arch])


@pytest.mark.parametrize("arch", list(SERVED))
def test_seq_sharded_caches_keep_the_reference_placements(runs, arch):
    """Every cache leaf at the reference's ``state_shardings(...,
    kv_seq_shard=True)`` spec, holding its shard only; and the caches that
    should be are split along their sequence over the model axis."""
    cache = checks.assert_cache_at_reference(runs[arch], arch, SERVED[arch])
    for name, leaf in cache.items():  # the model axis (the last) on the sequence dim
        seq = 2 if len(leaf["shape"]) == 5 else 1  # stacked (L, B, S, H, D) or per layer
        assert leaf["placements"].endswith(f"Shard(dim={seq}))"), (name, leaf)


@pytest.mark.parametrize("arch", list(SERVED))
def test_one_rank_seq_sharded_serving_is_bitwise_the_one_process(runs, arch):
    checks.test_one_rank_mesh_serving_is_bitwise_the_one_process(runs[arch], arch)


def test_write_cache_writes_each_ranks_own_rows(tmp_path):
    """A cache split along its sequence over 4 ranks: after each write of
    ``fw.SEQ_WRITES`` (inside one rank's rows, across boundaries, all of
    it) the ranks' shards, in rank order, are the plain write's cache."""
    out = tmp_path / "seq_writes.npz"
    workers.spawn(fw.seq_cache_rank, 4, 4, str(out))
    with np.load(out) as z:
        for i in range(len(fw.SEQ_WRITES)):
            np.testing.assert_array_equal(z[f"{i}/shards"], z[f"{i}/want"], err_msg=str(i))


def _decode_case(hq: int, hkv: int, b: int = 2, s: int = 32, d: int = 16):
    rng = np.random.default_rng(hq * 10 + hkv)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               for sh in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q, k, v


def _split(q, k, v, cur_len: int, parts: int):
    s = k.shape[1] // parts
    return [attention.decode_partial(q, k[:, i * s:(i + 1) * s], v[:, i * s:(i + 1) * s],
                                     cur_len, offset=i * s) for i in range(parts)]


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1)])
def test_combine_matches_decode_attention(hq, hkv, parts):
    """The partials of 1, 2 and 4 parts of a 32-row cache at ``cur_len`` 19
    (with 4 parts the last lies wholly past it), combined: within 1e-5 of
    the unsplit ``decode_attention`` (f32), GQA and MQA."""
    q, k, v = _decode_case(hq, hkv)
    want = attention.decode_attention(q, k, v, 19)
    got = attention.combine_partials(_split(q, k, v, 19, parts))[:, None]
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_a_part_past_cur_len_adds_nothing():
    """A part with no valid key: a finite max (``NEG_INF``), a zero sum (its
    weight) and a finite output; the combine equals the one over the
    other parts, bit for bit."""
    q, k, v = _decode_case(8, 2)
    parts = _split(q, k, v, 19, 4)
    m, l, o = parts[3]
    assert bool(torch.isfinite(m).all()) and (m == attention.NEG_INF).all()
    assert not l.any() and bool(torch.isfinite(o).all())
    assert torch.equal(attention.combine_partials(parts), attention.combine_partials(parts[:3]))


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1)])
def test_one_part_is_bitwise_decode_attention(hq, hkv):
    """The whole cache as one part: its weight is exactly 1, so the combine
    has ``decode_attention``'s bits (a (1, 1) mesh's sequence split)."""
    q, k, v = _decode_case(hq, hkv)
    want = attention.decode_attention(q, k, v, 19)
    assert torch.equal(attention.combine_partials(_split(q, k, v, 19, 1))[:, None], want)


def test_combine_is_bitwise_the_same_twice():
    q, k, v = _decode_case(8, 2)
    a = attention.combine_partials(_split(q, k, v, 27, 4))
    b = attention.combine_partials(_split(q, k, v, 27, 4))
    assert torch.equal(a, b)
