"""Offline BCQ on Pendulum, the port of ``examples/offline/bcq_pendulum.py``
(analogue of the reference's examples/offline/d4rl_bcq.py: VAE behavior model
+ perturbation actor).

    python examples_torch/offline/bcq_pendulum.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_pendulum, train_offline
from examples_torch.offline.d4rl_bcq import make_bcq


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return make_bcq(env)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_pendulum(gen)
    return train_offline(make_algo(env), env, data, dstate, gen, max_epochs=10, batch_size=128, label="offline BCQ")


if __name__ == "__main__":
    main()
