"""NPG on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_npg_hl.py`` (NPGParams).

    python examples_torch/mujoco/mujoco_npg_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import onpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import NPGExperimentBuilder
from tianshou_tpu_torch.highlevel.params import NPGParams

OVERRIDES = dict(num_envs=64)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        NPGExperimentBuilder,
        onpolicy_training_config(args, update_step_num_repetitions=1),
        params=NPGParams(lr=1e-3, actor_step_size=0.1, optim_critic_iters=20),
    )


if __name__ == "__main__":
    main()
