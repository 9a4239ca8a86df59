"""Offline discrete CQL on CartPole, the port of
``examples/offline/discrete_cql_cartpole.py`` (analogue of the reference's
examples/offline/atari_cql.py on the gathered-CartPole dataset; ALE absent).

    python examples_torch/offline/discrete_cql_cartpole.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_cartpole, train_offline
from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.models.mlp import Net


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return DiscreteCQL(
        model=Net(hidden_sizes=(64, 64), output_dim=2, num_atoms=64, input_dim=4),
        action_space=env.action_space, num_quantiles=64,
        optim=AdamOptimizerFactory(lr=3e-4),
        gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
        min_q_weight=10.0,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_cartpole(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=8, batch_size=64, label="offline discrete CQL")


if __name__ == "__main__":
    main()
