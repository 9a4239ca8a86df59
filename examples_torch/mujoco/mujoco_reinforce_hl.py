"""REINFORCE on the port's MuJoCo-class envs through the high-level API, the port
of ``examples/mujoco/mujoco_reinforce_hl.py`` (ReinforceParams with return
standardization).

    python examples_torch/mujoco/mujoco_reinforce_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import onpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import ReinforceExperimentBuilder
from tianshou_tpu_torch.highlevel.params import ReinforceParams

OVERRIDES = dict(num_envs=64)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        ReinforceExperimentBuilder,
        onpolicy_training_config(args, update_step_num_repetitions=1),
        params=ReinforceParams(lr=1e-3, return_standardization=True),
    )


if __name__ == "__main__":
    main()
