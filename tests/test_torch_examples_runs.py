"""Port example scripts end to end on the CPU through their own ``main``, at
tiny sizes: ``atari_rainbow`` (the catch game, the prioritized pixel replay),
``mujoco_sac`` (Reacher, the cheapest MuJoCo task: 50-step episodes) and
``dqn_cartpole``; each trains and its test phase returns finite rewards.
"""

import math

import numpy as np
import pytest
import torch

from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_cli import port_module

RUNS = {  # script: arguments after --device cpu
    "atari/atari_rainbow.py": ["--epochs", "1", "--epoch-num-steps", "40", "--start-steps", "40", "--num-envs", "4",
                               "--buffer-size", "200", "--batch-size", "4"],
    "mujoco/mujoco_sac.py": ["--task", "Reacher", "--epochs", "1", "--epoch-num-steps", "8", "--start-steps", "8",
                             "--num-envs", "2", "--batch-size", "16"],
    "discrete/dqn_cartpole.py": ["--epochs", "1", "--buffer-size", "2000"],
}


@pytest.mark.parametrize("rel", list(RUNS))
def test_a_script_trains_on_the_cpu_through_its_main(rel, capsys):
    res = port_module(rel).main(["--device", "cpu", *RUNS[rel]])
    assert res.epochs == 1 and res.gradient_step > 0 and res.env_step > 0
    assert math.isfinite(res.best_reward)
    assert all(p.device.type == "cpu" and bool(torch.isfinite(p).all()) for p in res.train_state.model.parameters())
    assert np.isfinite(res.last_chunk_stats.loss.numpy()).all()
    assert "best_reward=" in capsys.readouterr().out
    if rel.startswith("atari/"):
        state = res.buf_state  # the prioritized replay's tree: an internal node is the sum of its children
        bound = state.tree.shape[0] // 2
        assert torch.equal(state.tree[1:bound], state.tree[2::2] + state.tree[3::2])
