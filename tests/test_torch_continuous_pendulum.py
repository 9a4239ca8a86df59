"""SAC, TD3 and DDPG trained on the port's Pendulum to the reference's
threshold (reward -250, upstream test/continuous/test_sac_with_il.py:86), as
``tests/test_continuous.py:22-86`` trains the JAX package: 8 train and 10
test envs, a 50,000-row buffer, batch 128, T = 8, 0.5 updates per env step,
a 2,000-step prefill with the policy's own actions, at most 12 epochs of
4,000 steps. End-to-end training runs, marked ``slow`` and left out of the
tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_continuous_pendulum.py
"""

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import (
    ContinuousActorDeterministic,
    ContinuousActorProbabilistic,
    ContinuousCritic,
)
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow
HID = (128, 128)


def make_algo(kind: str, env: Pendulum):
    critic = ContinuousCritic(HID, input_dim=3, action_dim=1)
    if kind == "sac":
        return SAC(actor=ContinuousActorProbabilistic(HID, 1, conditioned_sigma=True, input_dim=3), critic=critic,
                   action_space=env.action_space, policy_optim=AdamOptimizerFactory(lr=3e-4),
                   critic_optim=AdamOptimizerFactory(lr=3e-4), gamma=0.99, tau=0.005, alpha="auto")
    lr = 3e-4 if kind == "td3" else 1e-3
    return (TD3 if kind == "td3" else DDPG)(
        actor=ContinuousActorDeterministic(HID, 1, input_dim=3), critic=critic, action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=lr), critic_optim=AdamOptimizerFactory(lr=lr), gamma=0.99, tau=0.005)


def run_pendulum(kind: str, seed: int = 0):
    torch.manual_seed(seed)
    env = Pendulum()
    algo = make_algo(kind, env)
    buffer = VectorReplayBuffer(50000, 8)
    bs = buffer.init(Batch(obs=torch.zeros(3), act=torch.zeros(1), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(3)),
                     device="cpu")
    params = OffPolicyTrainerParams(
        max_epochs=12, epoch_num_steps=4000, test_step_num_episodes=10, batch_size=128,
        collection_step_num_env_steps=8, update_per_step=0.5, start_steps=2000, start_random=False,
        stop_fn=lambda r: r >= -250, verbose=False,
    )
    trainer = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 8, device="cpu"), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), buffer, params)
    return trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_pendulum_reaches_the_threshold(kind):
    result = run_pendulum(kind)
    assert result.best_reward >= -250, f"{kind}: best_reward {result.best_reward} after {result.epochs} epochs"
    if kind == "sac":  # auto alpha moved off its start
        assert float(result.train_state.model.log_alpha.detach()) != 0.0
