"""zamba2-1.2b (reduced: 5 Mamba2 layers of d 128, the shared attention
block after layers 2 and 4, 4 SSM heads of 64, conv_dim 288, 4/2 attention
heads of 32) trained and served on the port's (data, model) meshes over 4
gloo ranks: ``in_proj``'s columns over the model axis, the causal conv on
each rank's conv channels, the chunk loop and the decode recurrence in one
``local_map`` on each rank's batch rows and SSM heads (on 2 model ranks
rank 0's channels end inside head 2, and B and C sit on the last rank),
the shared block on the attention's DTensor path, each application's
cache at its state rule.  Held against the reference's jitted step on its
forced (2, 2) and (1, 4) CPU meshes and its jitted ``prefill`` and
``decode_step`` on (2, 2), against the port's one process, and on a
(1, 1) mesh bitwise against that process (``_torch_mesh_family_checks``:
the tests and their tolerances).
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

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def arch():
    return ARCH


@pytest.fixture(scope="module")
def serve_shape():
    return (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return checks.family_runs(tmp_path_factory.mktemp("mesh_zamba"), [ARCH])
