"""A2C on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_a2c_hl.py`` (A2CParams).

    python examples_torch/mujoco/mujoco_a2c_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import onpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import A2CExperimentBuilder
from tianshou_tpu_torch.highlevel.params import A2CParams

OVERRIDES = dict(num_envs=64)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        A2CExperimentBuilder,
        onpolicy_training_config(args, collection_step_num_env_steps=80,
                                 update_step_num_repetitions=1),
        params=A2CParams(lr=7e-4, gae_lambda=0.95, vf_coef=0.5, ent_coef=0.01),
    )


if __name__ == "__main__":
    main()
