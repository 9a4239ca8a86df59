"""Offline CQL on Pendulum, the port of ``examples/offline/cql_pendulum.py``:
gather a dataset with SAC, then learn from the fixed buffer only (analogue
of the reference's examples/offline/d4rl_cql.py with the data-gathering step
of test/offline/gather_pendulum_data.py).

    python examples_torch/offline/cql_pendulum.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_pendulum, train_offline
from tianshou_tpu_torch.algorithm.imitation.cql import CQL
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return CQL(
        actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1, conditioned_sigma=True, input_dim=3),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=3, action_dim=1), action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4),
        cql_weight=1.0, with_lagrange=True,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_pendulum(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=10, batch_size=128, label="offline CQL")


if __name__ == "__main__":
    main()
