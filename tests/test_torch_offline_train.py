"""The offline, imitation and model-based family trained on the port's
classic envs to the reference's thresholds, as ``tests/test_offline.py`` and
``tests/test_modelbased.py`` train the JAX package, with their nets,
settings, budgets and thresholds. The expert datasets are gathered as
``tests/conftest.py:66-149`` gathers them: DQN trained on CartPole to 195
and 2,000 steps of 10 envs collected at eps 0.2; SAC trained on Pendulum to
-250 and 2,500 steps of 8 envs collected by its policy. End-to-end training
runs, marked ``slow`` and left out of the tier-1 run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_offline_train.py -n 4
"""

import numpy as np
import pytest
import torch

from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
from tianshou_tpu_torch.algorithm.imitation.cql import CQL
from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOffPolicyWrapper, ICMOnPolicyWrapper
from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.nchain import NChain
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import Discrete, VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import (
    VAE,
    ContinuousActorDeterministic,
    ContinuousActorProbabilistic,
    ContinuousCritic,
    Perturbation,
)
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic, IntrinsicCuriosityModule
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import (
    OfflineTrainer,
    OfflineTrainerParams,
    OffPolicyTrainer,
    OffPolicyTrainerParams,
    OnPolicyTrainer,
    OnPolicyTrainerParams,
)
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow
DEV = "cpu"


def _buffer(env, size, num):
    obs_dim = env.observation_space.shape
    act = torch.tensor(0) if isinstance(env.action_space, Discrete) else torch.zeros(env.action_space.shape)
    buffer = VectorReplayBuffer(size, num)
    return buffer, buffer.init(Batch(obs=torch.zeros(obs_dim), act=act, rew=torch.tensor(0.0),
                                     terminated=torch.tensor(False), truncated=torch.tensor(False),
                                     obs_next=torch.zeros(obs_dim)), device=DEV)


def _collectors(env, algo, buffer, n_train=10, n_test=10):
    return (DeviceCollector(VectorDeviceEnv(env, n_train, device=DEV), algo, buffer),
            DeviceCollector(VectorDeviceEnv(env, n_test, device=DEV), algo, None))


@pytest.fixture(scope="module")
def cartpole_data():
    """``tests/conftest.py:cartpole_data``: DQN to 195, then 2,000 steps of 10 envs at eps 0.2."""
    torch.manual_seed(0)
    env = CartPole()
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3),
               gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
    buffer, bs = _buffer(env, 20000, 10)
    tc, ec = _collectors(env, algo, buffer)
    params = OffPolicyTrainerParams(
        max_epochs=12, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, stop_fn=lambda r: r >= 195,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}, verbose=False)
    gen = torch.Generator().manual_seed(0)
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(algo.init(DEV), bs, gen)
    assert res.best_reward >= 195
    data, ds = _buffer(env, 20000, 10)
    res.train_state.hparams["eps_training"].fill_(0.2)
    coll = DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, data)
    coll.collect(res.train_state, coll.reset(gen), ds, gen, 2000, training=True)
    return env, data, ds


@pytest.fixture(scope="module")
def pendulum_data():
    """``tests/conftest.py:pendulum_data``: SAC to -250, then 2,500 steps of 8 envs by its policy."""
    torch.manual_seed(0)
    env = Pendulum()
    algo = SAC(actor=ContinuousActorProbabilistic((128, 128), 1, conditioned_sigma=True, input_dim=3),
               critic=ContinuousCritic((128, 128), input_dim=3, action_dim=1), action_space=env.action_space,
               policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4), gamma=0.99,
               tau=0.005, alpha="auto")
    buffer, bs = _buffer(env, 50000, 8)
    tc, ec = _collectors(env, algo, buffer, n_train=8)
    params = OffPolicyTrainerParams(
        max_epochs=12, epoch_num_steps=4000, test_step_num_episodes=10, batch_size=128,
        collection_step_num_env_steps=8, update_per_step=0.5, start_steps=2000, start_random=False,
        stop_fn=lambda r: r >= -250, verbose=False)
    gen = torch.Generator().manual_seed(0)
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(algo.init(DEV), bs, gen)
    assert res.best_reward >= -250
    data, ds = _buffer(env, 20000, 8)
    coll = DeviceCollector(VectorDeviceEnv(env, 8, device=DEV), algo, data)
    coll.collect(res.train_state, coll.reset(gen), ds, gen, 2500, training=True)
    return env, data, ds


def run_offline(env, buffer, bs, algo, stop, epochs=8, grad_steps=500, batch=64):
    """``tests/test_offline.py:run_offline``: up to ``epochs`` of ``grad_steps`` updates, 10 test episodes."""
    torch.manual_seed(1)
    params = OfflineTrainerParams(max_epochs=epochs, update_step_num_gradient_steps_per_epoch=grad_steps,
                                  batch_size=batch, test_step_num_episodes=10, stop_fn=lambda r: r >= stop,
                                  verbose=False)
    test = DeviceCollector(VectorDeviceEnv(env, 10, device=DEV), algo, None)
    res = OfflineTrainer(algo, buffer, test, params).run(algo.init(DEV), bs, torch.Generator().manual_seed(1))
    assert res.best_reward >= stop, f"best_reward {res.best_reward}"
    return res


# ---------------------------------------------------------------------------
# tests/test_offline.py
# ---------------------------------------------------------------------------
def test_bc_discrete(cartpole_data):
    env, buffer, bs = cartpole_data
    algo = ImitationLearning(model=DiscreteActor((64, 64), 2, input_dim=4), action_space=env.action_space,
                             optim=AdamOptimizerFactory(lr=1e-3))
    run_offline(env, buffer, bs, algo, 150)


def test_discrete_bcq(cartpole_data):
    env, buffer, bs = cartpole_data
    algo = DiscreteBCQ(model=Net((64, 64), 2, input_dim=4), imitator=DiscreteActor((64, 64), 2, input_dim=4),
                       action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4), gamma=0.97,
                       n_step_return_horizon=3, target_update_freq=320, unlikely_action_threshold=0.6)
    run_offline(env, buffer, bs, algo, 150)


def test_discrete_cql(cartpole_data):
    env, buffer, bs = cartpole_data
    algo = DiscreteCQL(model=Net((64, 64), 2, num_atoms=64, input_dim=4), action_space=env.action_space,
                       num_quantiles=64, optim=AdamOptimizerFactory(lr=3e-4), gamma=0.97, n_step_return_horizon=3,
                       target_update_freq=320, min_q_weight=10.0)
    run_offline(env, buffer, bs, algo, 150)


def test_discrete_crr(cartpole_data):
    env, buffer, bs = cartpole_data
    algo = DiscreteCRR(actor=DiscreteActor((64, 64), 2, input_dim=4),
                       critic=DiscreteCritic((64, 64), last_size=2, input_dim=4), action_space=env.action_space,
                       optim=AdamOptimizerFactory(lr=3e-4), gamma=0.97, target_update_freq=320)
    run_offline(env, buffer, bs, algo, 150)


def test_bc_continuous(pendulum_data):
    env, buffer, bs = pendulum_data
    algo = ImitationLearning(model=ContinuousActorDeterministic((64, 64), 1, max_action=2.0, input_dim=3),
                             action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3),
                             action_bound_method=None)
    run_offline(env, buffer, bs, algo, -800)


def test_td3_bc(pendulum_data):
    env, buffer, bs = pendulum_data
    algo = TD3BC(actor=ContinuousActorDeterministic((128, 128), 1, input_dim=3),
                 critic=ContinuousCritic((128, 128), input_dim=3, action_dim=1), action_space=env.action_space,
                 policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4), gamma=0.99,
                 tau=0.005, alpha=2.5)
    run_offline(env, buffer, bs, algo, -800)


def test_bcq(pendulum_data):
    env, buffer, bs = pendulum_data
    algo = BCQ(actor_perturbation=Perturbation((64, 64), 1, max_action=1.0, phi=0.05, input_dim=3),
               critic=ContinuousCritic((64, 64), input_dim=3, action_dim=1),
               vae=VAE((64,), (64,), 1, 2, max_action=1.0, input_dim=3), action_space=env.action_space, gamma=0.99,
               tau=0.005, forward_sampled_times=20, num_sampled_action=10)
    run_offline(env, buffer, bs, algo, -800)


def test_cql(pendulum_data):
    env, buffer, bs = pendulum_data
    algo = CQL(actor=ContinuousActorProbabilistic((128, 128), 1, conditioned_sigma=True, input_dim=3),
               critic=ContinuousCritic((128, 128), input_dim=3, action_dim=1), action_space=env.action_space,
               policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4), cql_weight=1.0,
               with_lagrange=True, num_repeat_actions=10)
    run_offline(env, buffer, bs, algo, -800, epochs=10, grad_steps=500, batch=128)


# ---------------------------------------------------------------------------
# tests/test_modelbased.py
# ---------------------------------------------------------------------------
def expert_rows(buffer, bs):
    """The stored rows of every ring, flattened: (obs, act)."""
    stored = (torch.arange(buffer.capacity)[None, :] < bs.size[:, None]).reshape(-1)
    obs = bs.data.obs.reshape(-1, bs.data.obs.shape[-1])[stored]
    return obs, bs.data.act.reshape(-1, bs.data.act.shape[-1])[stored]


def test_gail_pendulum(pendulum_data):
    env, buffer, bs = pendulum_data
    obs, act = expert_rows(buffer, bs)
    assert obs.shape == (2500 * 8, 3) and act.shape == (2500 * 8, 1)
    torch.manual_seed(0)
    algo = GAIL(actor=ContinuousActorProbabilistic((64, 64), 1, input_dim=3), critic=DiscreteCritic((64, 64), input_dim=3),
                action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
                disc_net=ContinuousCritic((64, 64), input_dim=3, action_dim=1), expert_obs=obs, expert_act=act,
                disc_optim=AdamOptimizerFactory(lr=1e-3), disc_update_num=2, gamma=0.95, gae_lambda=0.95,
                eps_clip=0.2, deterministic_eval=True)
    tc, ec = _collectors(env, algo, None, n_train=16, n_test=10)
    params = OnPolicyTrainerParams(max_epochs=15, epoch_num_steps=10000, test_step_num_episodes=10, batch_size=256,
                                   collection_step_num_env_steps=128, update_step_num_repetitions=5,
                                   stop_fn=lambda r: r >= -1100, verbose=False)
    res = OnPolicyTrainer(algo, tc, ec, params).run(algo.init(DEV), torch.Generator().manual_seed(0))
    assert res.best_reward >= -1100, f"best_reward {res.best_reward}"


def test_icm_dqn_cartpole():
    torch.manual_seed(0)
    env = CartPole()
    base = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3),
               gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
    algo = ICMOffPolicyWrapper(base, model=IntrinsicCuriosityModule((64, 32), 2, (64,), input_dim=4), lr_scale=1.0,
                               reward_scale=0.01, forward_loss_weight=0.2)
    buffer, bs = _buffer(env, 20000, 10)
    tc, ec = _collectors(env, algo, buffer)
    params = OffPolicyTrainerParams(
        max_epochs=15, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000, stop_fn=lambda r: r >= 195,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))}, verbose=False)
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(algo.init(DEV), bs, torch.Generator().manual_seed(0))
    assert res.best_reward >= 195, f"best_reward {res.best_reward}"
    assert "icm" in res.train_state.model


def test_icm_ppo_cartpole():
    torch.manual_seed(0)
    env = CartPole()
    base = PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
               deterministic_eval=True)
    algo = ICMOnPolicyWrapper(base, model=IntrinsicCuriosityModule((64, 32), 2, (64,), input_dim=4), lr_scale=1.0,
                              reward_scale=0.01, forward_loss_weight=0.2)
    tc, ec = _collectors(env, algo, None, n_train=16, n_test=10)
    params = OnPolicyTrainerParams(max_epochs=20, epoch_num_steps=10000, test_step_num_episodes=10, batch_size=256,
                                   collection_step_num_env_steps=128, update_step_num_repetitions=10,
                                   stop_fn=lambda r: r >= 195, verbose=False)
    res = OnPolicyTrainer(algo, tc, ec, params).run(algo.init(DEV), torch.Generator().manual_seed(0))
    assert res.best_reward >= 195, f"best_reward {res.best_reward}"


def test_psrl_nchain():
    env = NChain(n=5, slip=0.2)
    algo = PSRL(n_state=5, n_action=2, action_space=env.action_space, gamma=0.95, value_iterations=200)
    tc, ec = _collectors(env, algo, None, n_train=8, n_test=8)
    params = OnPolicyTrainerParams(max_epochs=10, epoch_num_steps=2000, test_step_num_episodes=8, batch_size=1024,
                                   collection_step_num_env_steps=100, update_step_num_repetitions=1,
                                   stop_fn=lambda r: r >= 340, verbose=False)
    res = OnPolicyTrainer(algo, tc, ec, params).run(algo.init(DEV), torch.Generator().manual_seed(0))
    # a random policy averages ~210 per 100-step episode; the optimal one ~360
    assert res.best_reward >= 340, f"best_reward {res.best_reward}"
    assert np.isfinite(res.train_state.extra["value"].numpy()).all()
