"""PPO on Atari pixels, the port of ``examples/atari/atari_ppo.py``
(NatureCNN actor + value critic, clip 0.1, GAE 0.95).

    python examples_torch/atari/atari_ppo.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.atari._runner import build_parser as _build_parser
from examples_torch.atari._runner import n_actions, run_onpolicy
from examples_torch.common import setup
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Discrete
from examples_torch.atari._runner import PixelCritic
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.models.atari import DQNet


def build_parser():
    return _build_parser(lr=2.5e-4, num_envs=16, batch_size=256)


def make_algo(args, n: int):
    return PPO(
        actor=DQNet(action_dim=n),   # NatureCNN -> logits
        critic=PixelCritic(),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=args.lr),
        eps_clip=0.1, gae_lambda=0.95, ent_coef=0.01, vf_coef=0.5,
        advantage_normalization=True,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup(args.device, args.seed)  # raises without a GPU unless --device cpu; seeds the nets' weights
    return run_onpolicy(args, make_algo(args, n_actions(args)))


if __name__ == "__main__":
    main()
