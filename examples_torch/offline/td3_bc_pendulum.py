"""Offline TD3+BC on Pendulum, the port of ``examples/offline/td3_bc_pendulum.py``
(analogue of the reference's examples/offline/d4rl_td3_bc.py with a gathered
dataset instead of d4rl).

    python examples_torch/offline/td3_bc_pendulum.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_pendulum, train_offline
from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic, ContinuousCritic


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return TD3BC(
        actor=ContinuousActorDeterministic(hidden_sizes=(128, 128), action_dim=1, input_dim=3),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=3, action_dim=1),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=3e-4),
        critic_optim=AdamOptimizerFactory(lr=3e-4),
        gamma=0.99, tau=0.005, alpha=2.5,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_pendulum(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=10, batch_size=128, label="offline TD3+BC")


if __name__ == "__main__":
    main()
