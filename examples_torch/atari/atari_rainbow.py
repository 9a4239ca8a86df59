"""Rainbow on Atari pixels, the port of ``examples/atari/atari_rainbow.py``
(noisy dueling C51 + prioritized replay + n-step 3).

The JAX script samples its replay uniformly, although its docstring names
prioritized replay; this port samples through ``PrioritizedVectorReplayBuffer``
(alpha 0.6, beta 0.4), as the reference script does by default. Every
other setting is the JAX script's.

    python examples_torch/atari/atari_rainbow.py [--device cpu]
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
from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
from tianshou_tpu_torch.models.atari import RainbowAtariNet


def build_parser():
    return _build_parser(lr=6.25e-5)


def make_algo(args, n: int):
    return RainbowDQN(
        model=RainbowAtariNet(action_dim=n, num_atoms=51),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=args.lr),
        num_atoms=51, v_min=-10.0, v_max=10.0,
        gamma=0.99, n_step_return_horizon=3, target_update_freq=500,
        eps_training=1.0, eps_inference=0.005,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup(args.device, args.seed)  # raises without a GPU unless --device cpu; seeds the nets' weights
    return run_offpolicy(args, make_algo(args, n_actions(args)), prioritized=True)


if __name__ == "__main__":
    main()
