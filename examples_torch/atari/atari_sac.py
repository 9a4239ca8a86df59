"""Discrete SAC on Atari pixels, the port of ``examples/atari/atari_sac.py``
(CNN actor logits + per-action Q critic, auto-alpha).

    python examples_torch/atari/atari_sac.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.atari._runner import build_parser as _build_parser
from examples_torch.atari._runner import n_actions, run_offpolicy
from examples_torch.common import setup
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
from tianshou_tpu_torch.models.atari import DQNet


def build_parser():
    return _build_parser(lr=1e-4)


def make_algo(args, n: int):
    return DiscreteSAC(
        actor=DQNet(action_dim=n),    # logits head
        critic=DQNet(action_dim=n),   # per-action Q head
        action_space=Discrete(n),
        policy_optim=AdamOptimizerFactory(lr=args.lr),
        critic_optim=AdamOptimizerFactory(lr=args.lr),
        alpha="auto", gamma=0.99, tau=0.005, n_step_return_horizon=3,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup(args.device, args.seed)  # raises without a GPU unless --device cpu; seeds the nets' weights
    return run_offpolicy(args, make_algo(args, n_actions(args)))


if __name__ == "__main__":
    main()
