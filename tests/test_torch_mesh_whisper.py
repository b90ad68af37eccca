"""whisper-tiny (reduced: 2 encoder and 4 decoder layers of d 128, 4 heads
of 32, 64 frames) trained and served on the port's (data, model) meshes
over 4 gloo ranks: the encoder's, the decoder's self- and
cross-attention on each rank's heads (``attention._local_heads``), the
stacked self and cross caches at ``state_placements``, written in each
rank's local shard (prefill's cross K/V too), decode on each rank's heads.
The training frames are the port's (``make_train_batch``'s), which the
reference's run takes; the served frames are a numpy draw both sides make.
Held against the reference's jitted step on its forced (2, 2) and (1, 4)
CPU meshes and its jitted ``prefill`` and ``decode_step`` on (2, 2),
against the port's one process, and on a (1, 1) mesh bitwise against that
process (``_torch_mesh_family_checks``: the tests and their tolerances).
Whisper's own 6 heads on a model axis of 4, its caches split along their
sequence, are ``test_torch_kv_seq_shard.py``'s.
"""
import pytest

import _torch_mesh_family_checks as checks
from _torch_mesh_family_checks import (  # noqa: F401  (collected here)
    test_cache_leaves_keep_the_reference_placements_and_only_their_shards,
    test_mesh_parameters_keep_the_reference_placements,
    test_mesh_serving_matches_the_one_process, test_mesh_serving_matches_the_reference,
    test_mesh_training_matches_the_one_process_run, test_mesh_training_matches_the_reference,
    test_one_rank_mesh_serving_is_bitwise_the_one_process,
    test_one_rank_mesh_training_is_bitwise_the_one_process_run)
from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def arch():
    return ARCH


@pytest.fixture(scope="module")
def serve_shape():
    return (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return checks.family_runs(tmp_path_factory.mktemp("mesh_whisper"), [ARCH])
