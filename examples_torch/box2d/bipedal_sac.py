"""SAC on Box2D BipedalWalker through the host path, the port of
``examples/box2d/bipedal_sac.py`` (reference examples/box2d/bipedal_hardcore_sac.py).
Needs ``gymnasium[box2d]``.

    python examples_torch/box2d/bipedal_sac.py --epochs 20 [--hardcore] [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.box2d._host import gym_factory, run_host
from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Box
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainerParams

TASK = "BipedalWalker-v3"


def make_algo(obs_dim: int, nu: int):
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=obs_dim, action_dim=nu),
        action_space=Box(low=[-1.0] * nu, high=[1.0] * nu),
        policy_optim=AdamOptimizerFactory(lr=3e-4),
        critic_optim=AdamOptimizerFactory(lr=3e-4),
        alpha="auto", tau=0.005, gamma=0.99, n_step_return_horizon=1,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--hardcore", action="store_true")
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    make = gym_factory(TASK, hardcore=args.hardcore)
    probe = make()
    obs_dim, nu = probe.observation_space.shape[0], probe.action_space.shape[0]
    probe.close()
    dev, gen = setup(args.device, args.seed)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=10_000, test_step_num_episodes=10,
        batch_size=256, collection_step_num_env_steps=10, update_per_step=0.2,
        start_steps=10_000, stop_fn=lambda r: r >= 300,
        verbose=True, seed=args.seed,
    )
    return run_host(make_algo(obs_dim, nu), make, args.num_envs, 10, 300_000,
                    transition_example(torch.zeros(obs_dim), torch.zeros(nu)), params, dev, gen)


if __name__ == "__main__":
    main()
