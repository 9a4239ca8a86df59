"""Offline behavior cloning on Pendulum, the port of ``examples/offline/il_pendulum.py``
(analogue of the reference's examples/offline/d4rl_il.py).

    python examples_torch/offline/il_pendulum.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_pendulum, train_offline
from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return ImitationLearning(
        model=ContinuousActorDeterministic(hidden_sizes=(64, 64), action_dim=1, max_action=2.0, input_dim=3),
        action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3),
        action_bound_method=None,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_pendulum(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=8, batch_size=128, label="offline BC")


if __name__ == "__main__":
    main()
