"""The distributional and discrete Q family trained on the port's classic
envs to the reference's thresholds, as ``tests/test_distributional.py:68-107``
and ``tests/test_trust_region.py:83-107`` train the JAX package: QRDQN, IQN
and FQF on CartPole to 195, BDQN on ``ContinuousToDiscrete(Pendulum(), 25)``
to -250, discrete SAC on CartPole to 195, with the reference tests' nets,
settings and budgets. End-to-end training runs, marked ``slow`` and left out
of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_distributional_train.py
"""

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.wrappers import ContinuousToDiscrete
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic, ImplicitQuantileNetwork
from tianshou_tpu_torch.models.mlp import BranchingNet, Net
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

COMMON = dict(gamma=0.95, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)


def run(env, algo, act_example, stop, max_epochs=15, anneal=True, start_random=True, seed=0):
    """``tests/test_distributional.py:run`` on the CPU: 10 train and 10 test envs, a 20,000-row replay,
    epochs of 5,000 steps, batch 64, T 10, 0.1 updates per env step, a 1,000-step prefill."""
    torch.manual_seed(seed)
    obs_dim = env.observation_space.shape
    buffer = VectorReplayBuffer(20000, 10)
    bs = buffer.init(Batch(obs=torch.zeros(obs_dim), act=act_example, rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False),
                           obs_next=torch.zeros(obs_dim)), device="cpu")
    params = OffPolicyTrainerParams(
        max_epochs=max_epochs, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, start_random=start_random,
        stop_fn=lambda r: r >= stop,
        train_fn=(lambda epoch, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}) if anneal else None,
        verbose=False,
    )
    trainer = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), buffer, params)
    result = trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(seed))
    assert result.best_reward >= stop, f"best_reward {result.best_reward}"
    return result


@pytest.mark.slow
def test_qrdqn_cartpole():
    env = CartPole()
    algo = QRDQN(model=Net((64, 64), 2, num_atoms=64, input_dim=4), action_space=env.action_space,
                 num_quantiles=64, optim=AdamOptimizerFactory(lr=1e-3), **COMMON)
    run(env, algo, torch.tensor(0), 195)


@pytest.mark.slow
def test_iqn_cartpole():
    env = CartPole()
    algo = IQN(model=ImplicitQuantileNetwork((64, 64), 2, input_dim=4), action_space=env.action_space,
               sample_size=32, online_sample_size=8, target_sample_size=8, optim=AdamOptimizerFactory(lr=1e-3),
               **COMMON)
    run(env, algo, torch.tensor(0), 195, max_epochs=25)


@pytest.mark.slow
def test_fqf_cartpole():
    env = CartPole()
    algo = FQF(model=ImplicitQuantileNetwork((64, 64), 2, input_dim=4), action_space=env.action_space,
               num_fractions=32, ent_coef=10.0, optim=AdamOptimizerFactory(lr=1e-3), **COMMON)
    run(env, algo, torch.tensor(0), 195)


@pytest.mark.slow
def test_bdqn_discretized_pendulum():
    env = ContinuousToDiscrete(Pendulum(), 25)
    algo = BDQN(model=BranchingNet((128, 128), 1, 25, input_dim=3), action_space=env.action_space, gamma=0.99,
                target_update_freq=320, eps_training=0.3, optim=AdamOptimizerFactory(lr=1e-3))
    run(env, algo, torch.zeros(1, dtype=torch.int64), -250)


@pytest.mark.slow
def test_discrete_sac_cartpole():
    env = CartPole()
    algo = DiscreteSAC(actor=DiscreteActor((64, 64), 2, input_dim=4),
                       critic=DiscreteCritic((64, 64), last_size=2, input_dim=4), action_space=env.action_space,
                       policy_optim=AdamOptimizerFactory(lr=5e-4), critic_optim=AdamOptimizerFactory(lr=5e-4),
                       gamma=0.95, tau=0.005, alpha=0.05, n_step_return_horizon=3)
    run(env, algo, torch.tensor(0), 195, anneal=False, start_random=False)
