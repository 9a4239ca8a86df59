"""Dataset gathering for the port's offline example family (the twin of
``examples/offline/_gather.py``): train a behavior policy online, roll it
into a fixed buffer (the analogue of the reference's
test/offline/gather_pendulum_data.py / gather_cartpole_data.py, replacing the
d4rl downloads its d4rl_*.py scripts use).

Each gatherer takes the run's ``torch.Generator`` (in place of the JAX
key); everything lives on that generator's device.
"""

from __future__ import annotations

import torch

from examples_torch.common import transition_example
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def _gather(env, algo, example, params, generator: torch.Generator, dataset_size: int):
    """Train ``algo`` online (8 + 10 envs, a 50,000-row replay), then collect ``dataset_size`` rows of 8 envs
    with the trained policy: (data buffer, its state, the trained train state)."""
    dev = generator.device
    ts = algo.init(dev)
    rb = VectorReplayBuffer(total_size=50_000, buffer_num=8)
    rb_state = rb.init(example, device=dev)
    tc = DeviceCollector(VectorDeviceEnv(env, 8, device=dev), algo, rb)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=dev), algo, None)
    res = OffPolicyTrainer(algo, tc, ec, rb, params).run(ts, rb_state, generator)
    print(f"[gather] behavior policy best_reward={res.best_reward:.1f}", flush=True)

    data = VectorReplayBuffer(total_size=dataset_size, buffer_num=8)
    dstate = data.init(example, device=dev)
    dc = DeviceCollector(VectorDeviceEnv(env, 8, device=dev), algo, data)
    dc.collect(res.train_state, dc.reset(generator), dstate, generator, dataset_size // 8)
    return data, dstate, res.train_state


def gather_pendulum(generator: torch.Generator, dataset_size: int = 20_000):
    """Train SAC to >= -250 on Pendulum and collect a mixed dataset.
    Returns (env, data_buffer, data_state, expert_ts, expert_algo)."""
    env = Pendulum()
    sac = SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1, conditioned_sigma=True, input_dim=3),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=3, action_dim=1), action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4),
    )
    params = OffPolicyTrainerParams(
        max_epochs=10, epoch_num_steps=4000, batch_size=128, collection_step_num_env_steps=8,
        update_per_step=0.5, start_steps=2000, start_random=False, stop_fn=lambda r: r >= -250,
    )
    data, dstate, ts = _gather(env, sac, transition_example(torch.zeros(3), torch.zeros(1)), params, generator, dataset_size)
    return env, data, dstate, ts, sac


def gather_cartpole(generator: torch.Generator, dataset_size: int = 20_000):
    """Train DQN to >= 195 on CartPole and collect a dataset (the discrete
    analogue, reference gather_cartpole_data.py)."""
    env = CartPole()
    dqn = DQN(
        model=Net(hidden_sizes=(64, 64), output_dim=2, input_dim=4), action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3,
        target_update_freq=320, eps_training=0.3,
    )
    params = OffPolicyTrainerParams(
        max_epochs=10, epoch_num_steps=5000, batch_size=64, collection_step_num_env_steps=8,
        update_per_step=0.25, start_steps=1000, stop_fn=lambda r: r >= 195,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 20000))},
    )
    data, dstate, ts = _gather(env, dqn, transition_example(torch.zeros(4), torch.tensor(0)), params, generator, dataset_size)
    return env, data, dstate, ts, dqn


def train_offline(algo, env, data, dstate, generator: torch.Generator, max_epochs: int, batch_size: int,
                  label: str):
    """Learn ``algo`` from the fixed dataset alone through ``OfflineTrainer`` (epochs of 500 updates, 10 test
    envs) and print its best test reward."""
    from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams

    dev = generator.device
    ts = algo.init(dev)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=dev), algo, None)
    res = OfflineTrainer(algo, data, ec, OfflineTrainerParams(
        max_epochs=max_epochs, update_step_num_gradient_steps_per_epoch=500, batch_size=batch_size,
    )).run(ts, dstate, generator)
    print(f"{label}: best_reward={res.best_reward:.1f}", flush=True)
    return res
