"""DQN trained on the port's CartPole to the reference's threshold (reward
195, upstream test/discrete/test_dqn.py:69), as ``tests/test_dqn.py`` trains
the JAX package: uniform replay, prioritized replay, and the fused megastep.
End-to-end training runs, marked ``slow`` and left out of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_dqn_cartpole.py
"""

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def run_dqn(buffer, fused_megastep=False, seed=0):
    """The configuration of ``tests/test_dqn.py:17-48`` on the CPU."""
    torch.manual_seed(seed)
    env = CartPole()
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
               eps_training=0.3)
    bs = buffer.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(4)),
                     device="cpu")
    params = OffPolicyTrainerParams(
        max_epochs=15, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, fused_megastep=fused_megastep,
        stop_fn=lambda r: r >= 195,
        train_fn=lambda epoch, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))},
        verbose=False,
    )
    trainer = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), buffer, params)
    return trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(seed))


@pytest.mark.slow
def test_dqn_cartpole():
    result = run_dqn(VectorReplayBuffer(20000, 10))
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_dqn_prioritized():
    result = run_dqn(PrioritizedVectorReplayBuffer(20000, 10, alpha=0.6, beta=0.4))
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_dqn_fused_megastep():
    result = run_dqn(VectorReplayBuffer(20000, 10), fused_megastep=True)
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"
    assert result.gradient_step > 0
