"""QRDQN on Atari pixels, the port of ``examples/atari/atari_qrdqn.py`` (200
quantiles, n-step 3).

    python examples_torch/atari/atari_qrdqn.py [--device cpu]
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
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN
from tianshou_tpu_torch.models.atari import QRDQNet


def build_parser():
    return _build_parser(lr=5e-5)


def make_algo(args, n: int):
    return QRDQN(
        model=QRDQNet(action_dim=n, num_quantiles=200),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=args.lr),
        num_quantiles=200,
        gamma=0.99, n_step_return_horizon=3, target_update_freq=500,
        eps_training=1.0, eps_inference=0.005,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup(args.device, args.seed)  # raises without a GPU unless --device cpu; seeds the nets' weights
    return run_offpolicy(args, make_algo(args, n_actions(args)))


if __name__ == "__main__":
    main()
