"""DDPG + Hindsight Experience Replay on a sparse goal-reaching task, the port
of ``examples/mujoco/goal_her_ddpg.py`` (the analogue of the reference's
``examples/mujoco/fetch_her_ddpg.py``).

The reference drives gymnasium-robotics FetchReach (reward -1 until the goal
is hit). That dependency is absent, so the example runs the device
``GoalReach`` env: the same sparse goal-conditioned structure
({observation, achieved_goal, desired_goal} obs, -1/0 reward), with the HER
relabelling inside the update's sample (data/buffer/her.py: relabel on
sample, no host round trip).

    python examples_torch/mujoco/goal_her_ddpg.py            # with HER
    python examples_torch/mujoco/goal_her_ddpg.py --no-her   # ablation
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import time

import torch
from torch import nn

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.models.mlp import MLP


class GoalActor(nn.Module):
    """``tanh(MLP([observation, desired_goal]))``, a 2-d action."""

    def __init__(self, hidden: tuple = (256, 256)) -> None:
        super().__init__()
        self.mlp = MLP(4, hidden, 2)

    def forward(self, obs):
        return torch.tanh(self.mlp(torch.cat([obs.observation, obs.desired_goal], dim=-1)))


class GoalCritic(nn.Module):
    """``MLP([observation, desired_goal, act])`` -> ``[B]``."""

    def __init__(self, hidden: tuple = (256, 256)) -> None:
        super().__init__()
        self.mlp = MLP(6, hidden, 1)

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs.observation, obs.desired_goal, act], dim=-1))[:, 0]


def goal_example():
    """A transition of the goal env, for the buffer's layout."""
    from tianshou_tpu_torch.data.batch import Batch

    obs = Batch(observation=torch.zeros(2), achieved_goal=torch.zeros(2), desired_goal=torch.zeros(2))
    return transition_example(obs, torch.zeros(2))


def train(seed: int = 0, epochs: int = 10, epoch_num_steps: int = 4000,
          num_envs: int = 8, batch_size: int = 128, use_her: bool = True,
          verbose: bool = True, device=None):
    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.her import HERVectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.goal_reach import GoalReach
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    dev, gen = setup(device, seed)
    env = GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)
    algo = DDPG(
        actor=GoalActor(), critic=GoalCritic(),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.98, tau=0.005,
        exploration_noise=GaussianNoise(sigma=0.3),
        action_scaling=False,
    )
    ts = algo.init(dev)
    if use_her:
        buffer = HERVectorReplayBuffer(
            total_size=50_000, buffer_num=num_envs,
            compute_reward_fn=env.compute_reward, horizon=60, future_k=8.0,
        )
    else:
        buffer = VectorReplayBuffer(total_size=50_000, buffer_num=num_envs)
    buf_state = buffer.init(goal_example(), device=dev)
    tc = DeviceCollector(VectorDeviceEnv(env, num_envs, device=dev), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 20, device=dev), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=20, batch_size=batch_size,
        collection_step_num_env_steps=num_envs, update_per_step=0.25,
        start_steps=2000, start_random=False, verbose=verbose, seed=seed,
    )
    t0 = time.time()
    result = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    if verbose:
        print(f"her={use_her} best_reward={result.best_reward:.1f} "
              f"({result.env_step / max(time.time() - t0, 1e-9):,.0f} steps/s)", flush=True)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--no-her", action="store_true")
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    return train(seed=args.seed, epochs=args.epochs, use_her=not args.no_her, device=args.device)


if __name__ == "__main__":
    main()
