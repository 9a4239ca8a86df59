"""Two gloo processes through ``tianshou_tpu_torch/parallel/distributed.py``,
the twin of ``tests/test_distributed.py`` and ``tests/distributed_worker.py``.

The ranks (``tests/_torch_mesh_worker.py``, kind ``distributed``) meet at a
file, call ``initialize`` twice (the second call a no-op) and once with
another world (which must raise), take their ``process_env_slice`` of 16
envs, assemble a global ``[16, 4]`` ``DTensor`` from their rows with
``host_local_to_global``, take its mean across the processes, and bring a
doubled-plus-one program's rows back with ``global_to_host_local``.
"""

import numpy as np
import pytest

from tests._torch_mesh_worker import join, spawn
from tests._torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    return join(spawn("distributed", 2, tmp), "distributed", tmp)


def test_initialize_is_idempotent_and_refuses_another_world(ranks):
    assert all(rec["raised"] for rec in ranks)


def test_env_slices_and_global_array(ranks):
    for r, rec in enumerate(ranks):
        assert rec["slice"] == (8 * r, 8)
        assert rec["shape"] == (16, 4)


@pytest.mark.parametrize("rank", [0, 1])
def test_global_mean_and_rows_back(ranks, rank):
    rec = ranks[rank]
    np.testing.assert_allclose(rec["mean"].numpy(), np.mean(np.arange(16, dtype=np.float32)), rtol=1e-6)
    np.testing.assert_allclose(rec["back"], rec["local"] * 2.0 + 1.0, rtol=1e-6)
