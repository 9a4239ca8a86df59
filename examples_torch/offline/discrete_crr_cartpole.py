"""Offline discrete CRR on CartPole, the port of
``examples/offline/discrete_crr_cartpole.py`` (analogue of the reference's
examples/offline/atari_crr.py on the gathered-CartPole dataset; ALE absent).

    python examples_torch/offline/discrete_crr_cartpole.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_cartpole, train_offline
from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return DiscreteCRR(
        actor=DiscreteActor(hidden_sizes=(64, 64), action_dim=2, input_dim=4),
        critic=DiscreteCritic(hidden_sizes=(64, 64), last_size=2, input_dim=4),
        action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4),
        gamma=0.97, target_update_freq=320,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_cartpole(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=8, batch_size=64, label="offline discrete CRR")


if __name__ == "__main__":
    main()
