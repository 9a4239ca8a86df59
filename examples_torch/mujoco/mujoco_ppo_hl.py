"""PPO on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_ppo_hl.py`` (PPOParams: clip 0.2, GAE 0.95, advantage
normalization).

    python examples_torch/mujoco/mujoco_ppo_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import onpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import PPOExperimentBuilder
from tianshou_tpu_torch.highlevel.params import PPOParams

OVERRIDES = dict(num_envs=64)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        PPOExperimentBuilder,
        onpolicy_training_config(args),
        params=PPOParams(lr=3e-4, eps_clip=0.2, gae_lambda=0.95,
                         advantage_normalization=True, ent_coef=0.0),
    )


if __name__ == "__main__":
    main()
