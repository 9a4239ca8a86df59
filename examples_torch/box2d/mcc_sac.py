"""SAC on the device MountainCarContinuous, the port of ``examples/box2d/mcc_sac.py``
(reference examples/box2d/mcc_sac.py: auto-alpha).

    python examples_torch/box2d/mcc_sac.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.mountain_car import MountainCarContinuous
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def make_algo(args, env):
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1, conditioned_sigma=True, input_dim=2),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=2, action_dim=1),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=args.lr),
        critic_optim=AdamOptimizerFactory(lr=args.lr),
        alpha="auto", gamma=0.99, tau=0.005,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--epoch-num-steps", type=int, default=12_000)
    p.add_argument("--num-envs", type=int, default=16)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev, gen = setup(args.device, args.seed)
    env = MountainCarContinuous()
    algo = make_algo(args, env)
    ts = algo.init(dev)
    buffer = VectorReplayBuffer(total_size=50_000, buffer_num=args.num_envs)
    buf_state = buffer.init(transition_example(torch.zeros(2), torch.zeros(1)), device=dev)
    tc = DeviceCollector(VectorDeviceEnv(env, args.num_envs, device=dev), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=dev), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
        test_step_num_episodes=10, batch_size=128,
        collection_step_num_env_steps=10, update_per_step=0.2, start_steps=5_000,
        stop_fn=lambda r: r >= 90,
        verbose=True, seed=args.seed,
    )
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} env_steps={res.env_step}", flush=True)
    return res


if __name__ == "__main__":
    main()
