"""DDPG + HER on the sparse GoalReach env, the port of
``examples/continuous/ddpg_her_goalreach.py`` (analogue of the reference's
examples/mujoco/fetch_her_ddpg.py). Without HER this task is unlearnable;
with HER it solves in a few epochs.

    python examples_torch/continuous/ddpg_her_goalreach.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.mujoco.goal_her_ddpg import GoalActor, GoalCritic, goal_example
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.her import HERVectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.goal_reach import GoalReach
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.exploration.noise import GaussianNoise
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return DDPG(
        actor=GoalActor((128, 128)), critic=GoalCritic((128, 128)), action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.98, tau=0.005, exploration_noise=GaussianNoise(sigma=0.3), action_scaling=False,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, gen = setup(args.device, 0)
    env = GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)
    algo = make_algo(env)
    ts = algo.init(device)
    buffer = HERVectorReplayBuffer(
        total_size=50000, buffer_num=8, compute_reward_fn=env.compute_reward,
        horizon=60, future_k=8.0,
    )
    buf_state = buffer.init(goal_example(), device=device)
    tc = DeviceCollector(VectorDeviceEnv(env, 8, device=device), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=device), algo, None)
    res = OffPolicyTrainer(algo, tc, ec, buffer, OffPolicyTrainerParams(
        max_epochs=8, epoch_num_steps=4000, batch_size=128, test_step_num_episodes=20,
        collection_step_num_env_steps=8, update_per_step=0.25,
        start_steps=2000, start_random=False,
    )).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} (random ~ -55, solved ~ -9)", flush=True)
    return res


if __name__ == "__main__":
    main()
