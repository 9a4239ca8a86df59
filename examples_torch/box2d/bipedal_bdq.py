"""Branching dueling Q (BDQN) on BipedalWalker with per-dimension discretized
actions, the port of ``examples/box2d/bipedal_bdq.py`` (reference
examples/box2d/bipedal_bdq.py: ContinuousToDiscrete 25 bins x 4 dims,
BranchingNet). Needs ``gymnasium[box2d]``.

    python examples_torch/box2d/bipedal_bdq.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import numpy as np
import torch

from examples_torch.box2d._host import run_host
from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import MultiDiscrete
from tianshou_tpu_torch.models.mlp import BranchingNet
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainerParams

BINS = 25


class _DiscretizedBipedal:
    """Host-side per-dimension discretization (reference gym_wrappers.py:8
    ContinuousToDiscrete applied to the gym env)."""

    def __init__(self):
        import gymnasium as gym

        self.env = gym.make("BipedalWalker-v3")
        self.observation_space = self.env.observation_space
        low, high = self.env.action_space.low, self.env.action_space.high
        self._mesh = np.stack([np.linspace(lo, hi, BINS) for lo, hi in zip(low, high)])
        self.action_space = gym.spaces.MultiDiscrete([BINS] * 4)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, act):
        cont = self._mesh[np.arange(4), np.asarray(act, dtype=np.int64)]
        return self.env.step(cont)

    def close(self):
        self.env.close()


def make_algo(args):
    return BDQN(
        model=BranchingNet(hidden_sizes=(512, 256), num_branches=4, action_per_branch=BINS, input_dim=24),
        action_space=MultiDiscrete([BINS] * 4),
        optim=AdamOptimizerFactory(lr=args.lr),
        gamma=0.99, target_update_freq=1000, eps_training=0.73,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--epoch-num-steps", type=int, default=80_000)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--buffer-size", type=int, default=100_000)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _DiscretizedBipedal().close()  # raises ImportError here, before training, where gymnasium's Box2D is absent
    dev, gen = setup(args.device, args.seed)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
        test_step_num_episodes=4, batch_size=512,
        collection_step_num_env_steps=10, update_per_step=0.0625, start_steps=2_000,
        stop_fn=lambda r: r >= 300,
        train_fn=lambda ep, step: {"eps_training": max(0.0, 0.73 * (1 - step / 500_000))},
        verbose=True, seed=args.seed,
    )
    return run_host(make_algo(args), _DiscretizedBipedal, args.num_envs, 4, args.buffer_size,
                    transition_example(torch.zeros(24), torch.zeros(4, dtype=torch.int64)), params, dev, gen)


if __name__ == "__main__":
    main()
