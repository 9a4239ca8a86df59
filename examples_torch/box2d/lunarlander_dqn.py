"""DQN on Box2D LunarLander through the host path, the port of
``examples/box2d/lunarlander_dqn.py`` (reference examples/box2d/lunarlander_dqn.py:
128x128 dueling net, n-step 4). Needs ``gymnasium[box2d]``.

    python examples_torch/box2d/lunarlander_dqn.py --epochs 10 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.box2d._host import gym_factory, run_host
from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.models.mlp import DuelingNet
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainerParams

TASK = "LunarLander-v3"


def make_algo(args, obs_dim: int, n_act: int):
    return DQN(
        model=DuelingNet(hidden_sizes=(128, 128), action_dim=n_act, input_dim=obs_dim),
        action_space=Discrete(n_act),
        optim=AdamOptimizerFactory(lr=args.lr),
        gamma=0.99, n_step_return_horizon=4, target_update_freq=320,
        eps_training=0.73,  # reference lunarlander eps schedule start
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--num-envs", type=int, default=16)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    make = gym_factory(TASK)
    probe = make()
    obs_dim, n_act = probe.observation_space.shape[0], int(probe.action_space.n)
    probe.close()
    dev, gen = setup(args.device, args.seed)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=10_000, test_step_num_episodes=10,
        batch_size=128, collection_step_num_env_steps=10, update_per_step=0.125,
        start_steps=5_000, stop_fn=lambda r: r >= 200,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.73 * (1 - step / 50_000))},
        test_fn=lambda ep, step: {"eps_inference": 0.01},
        verbose=True, seed=args.seed,
    )
    return run_host(make_algo(args, obs_dim, n_act), make, args.num_envs, 10, 100_000,
                    transition_example(torch.zeros(obs_dim), torch.tensor(0)), params, dev, gen)


if __name__ == "__main__":
    main()
