"""The on-policy family trained on the port's CartPole as ``tests/test_onpolicy.py``
trains the JAX package (upstream test/discrete/test_ppo.py, test_a2c_with_il.py):
PPO and A2C to the reference's threshold of 195, REINFORCE to 140, and PPO
with the dual and value clips to 150. End-to-end training runs, marked
``slow`` and left out of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_onpolicy_cartpole.py
"""

import pytest
import torch

from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.modelfree.reinforce import Reinforce
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def run_onpolicy(algo, max_epochs=20, repetitions=10, batch_size=256, T=128, stop=195, seed=0):
    """``tests/test_onpolicy.py:17-33`` on the CPU: 16 train and 10 test envs, epochs of 10,000 steps."""
    env = CartPole()
    params = OnPolicyTrainerParams(
        max_epochs=max_epochs, epoch_num_steps=10000, test_step_num_episodes=10, batch_size=batch_size,
        collection_step_num_env_steps=T, update_step_num_repetitions=repetitions, stop_fn=lambda r: r >= stop,
        verbose=False,
    )
    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 16, device="cpu"), algo, None),
                              DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), params)
    return trainer.run(algo.init("cpu"), torch.Generator().manual_seed(seed))


def _actor_critic():
    torch.manual_seed(0)
    return DiscreteActor((64, 64), 2, input_dim=4), DiscreteCritic((64, 64), input_dim=4)


@pytest.mark.slow
def test_ppo_cartpole():
    actor, critic = _actor_critic()
    algo = PPO(actor=actor, critic=critic, action_space=CartPole().action_space,
               optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), gamma=0.99, gae_lambda=0.95, eps_clip=0.2,
               ent_coef=0.01, deterministic_eval=True)
    result = run_onpolicy(algo)
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_a2c_cartpole():
    actor, critic = _actor_critic()
    algo = A2C(actor=actor, critic=critic, action_space=CartPole().action_space,
               optim=AdamOptimizerFactory(lr=7e-4, max_grad_norm=0.5), gamma=0.99, gae_lambda=0.95, ent_coef=0.01,
               vf_coef=0.5, deterministic_eval=True)
    result = run_onpolicy(algo, repetitions=1, batch_size=2048, T=32, max_epochs=25)
    assert result.best_reward >= 195, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_reinforce_improves():
    actor, _ = _actor_critic()
    algo = Reinforce(actor=actor, action_space=CartPole().action_space, optim=AdamOptimizerFactory(lr=1e-3),
                     gamma=0.99, return_standardization=True, deterministic_eval=True)
    result = run_onpolicy(algo, repetitions=1, batch_size=4096, T=256, max_epochs=10, stop=140)
    assert result.best_reward >= 140, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_ppo_dual_and_value_clip():
    actor, critic = _actor_critic()
    algo = PPO(actor=actor, critic=critic, action_space=CartPole().action_space,
               optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), dual_clip=3.0, value_clip=True,
               deterministic_eval=True)
    result = run_onpolicy(algo, max_epochs=8, stop=150)
    assert result.best_reward >= 150, f"best_reward {result.best_reward}"
