"""NPG, TRPO and PPO+gSDE trained in the port on the CPU, as
``tests/test_trust_region.py`` and ``tests/test_sde.py`` train the JAX
package (upstream test/discrete/test_npg.py, test/continuous/test_trpo.py):
NPG and TRPO on CartPole to the reference's 195, TRPO on Pendulum to -450,
and PPO with gSDE on Pendulum to -250. End-to-end training runs, marked
``slow`` and left out of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_trust_region_train.py
"""

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def run(algo, env, stop, max_epochs=15, epoch_steps=10000, T=128, batch_size=1024, repeat=1, n_train=16):
    """``tests/test_trust_region.py:26-46``'s protocol on the CPU: 16 train and 10 test envs."""
    params = OnPolicyTrainerParams(
        max_epochs=max_epochs, epoch_num_steps=epoch_steps, test_step_num_episodes=10, batch_size=batch_size,
        collection_step_num_env_steps=T, update_step_num_repetitions=repeat, stop_fn=lambda r: r >= stop,
        verbose=False)
    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, n_train, device="cpu"), algo, None),
                              DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), params)
    return trainer.run(algo.init("cpu"), torch.Generator().manual_seed(0))


@pytest.mark.slow
@pytest.mark.parametrize("cls", [NPG, TRPO], ids=["npg", "trpo"])
def test_cartpole(cls):
    torch.manual_seed(0)
    env = CartPole()
    algo = cls(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3), gamma=0.99, gae_lambda=0.95,
               deterministic_eval=True)
    result = run(algo, env, 195)
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_trpo_pendulum():
    """``tests/test_trust_region.py:109-135``: the Normal distribution's KL and Fisher product."""
    torch.manual_seed(0)
    env = Pendulum()
    algo = TRPO(actor=ContinuousActorProbabilistic((64, 64), 1, input_dim=3),
                critic=DiscreteCritic((64, 64), input_dim=3), action_space=env.action_space,
                optim=AdamOptimizerFactory(lr=1e-3), gamma=0.95, gae_lambda=0.95, optim_critic_iters=5, max_kl=0.01,
                deterministic_eval=True)
    result = run(algo, env, -450)
    assert result.best_reward >= -450, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_ppo_sde_pendulum():
    """``tests/test_sde.py:121-144``: PPO with gSDE's carried noise."""
    torch.manual_seed(0)
    env = Pendulum()
    algo = PPO(actor=ContinuousActorProbabilistic((64, 64), 1, ppo_init=True, sde=True, sigma_init=-1.0, input_dim=3),
               critic=ContinuousCritic((64, 64), use_action=False, ppo_init=True, input_dim=3),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
               deterministic_eval=True, gamma=0.95, gae_lambda=0.95, eps_clip=0.2, value_clip=True,
               return_standardization=True, recompute_advantage=True, vf_coef=0.25)
    result = run(algo, env, -250, max_epochs=12, epoch_steps=4000, T=64, batch_size=128, repeat=10)
    assert result.best_reward >= -250, f"best_reward {result.best_reward}"
