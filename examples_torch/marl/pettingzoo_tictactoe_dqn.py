"""DQN self-play on the REAL PettingZoo tic-tac-toe (pettingzoo.classic
tictactoe_v3) through the AEC adapter and the multi-agent dispatcher, the
port of ``examples/marl/pettingzoo_tictactoe_dqn.py`` (the analogue of the
reference's test/pettingzoo/tic_tac_toe.py, which drives the same env). Any
pettingzoo.classic AEC game with discrete actions and an action_mask runs
through the host multi-agent path unchanged. Needs ``pettingzoo``.

    python examples_torch/marl/pettingzoo_tictactoe_dqn.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.marl.tictactoe_selfplay import selfplay
from tianshou_tpu_torch.env.pettingzoo_env import PettingZooEnv


def make_env():
    from pettingzoo.classic import tictactoe_v3

    return PettingZooEnv(tictactoe_v3.env())


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def main(argv=None):
    args = build_parser().parse_args(argv)
    make_env().close()  # raises ImportError here, before training, where pettingzoo is absent
    return selfplay(make_env, *setup(args.device, 0))


if __name__ == "__main__":
    main()
