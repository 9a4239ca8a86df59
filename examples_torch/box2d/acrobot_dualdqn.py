"""Dueling double DQN on the device Acrobot, the port of
``examples/box2d/acrobot_dualdqn.py`` (reference examples/box2d/acrobot_dualdqn.py:
dueling Net, eps decay, 500-step cap).

    python examples_torch/box2d/acrobot_dualdqn.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.acrobot import Acrobot
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.mlp import DuelingNet
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def make_algo(args, env):
    return DQN(
        model=DuelingNet(hidden_sizes=(128, 128), action_dim=3, input_dim=6),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=args.lr),
        gamma=0.99, n_step_return_horizon=3, target_update_freq=320,
        eps_training=0.73,  # reference's tuned start eps
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--epoch-num-steps", type=int, default=10_000)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--buffer-size", type=int, default=20_000)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev, gen = setup(args.device, args.seed)
    env = Acrobot()
    algo = make_algo(args, env)
    ts = algo.init(dev)
    buffer = VectorReplayBuffer(total_size=args.buffer_size, buffer_num=args.num_envs)
    buf_state = buffer.init(transition_example(torch.zeros(6), torch.tensor(0)), device=dev)
    tc = DeviceCollector(VectorDeviceEnv(env, args.num_envs, device=dev), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=dev), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
        test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000,
        stop_fn=lambda r: r >= -80,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.73 * (1 - step / 50_000))},
        verbose=True, seed=args.seed,
    )
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} env_steps={res.env_step}", flush=True)
    return res


if __name__ == "__main__":
    main()
