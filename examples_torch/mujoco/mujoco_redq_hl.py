"""REDQ on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_redq_hl.py`` (REDQParams: ensemble 10, subset 2, actor
delay 20).

    python examples_torch/mujoco/mujoco_redq_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import offpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import REDQExperimentBuilder
from tianshou_tpu_torch.highlevel.module import ActorFactoryDefault, CriticFactoryDefault
from tianshou_tpu_torch.highlevel.params import REDQParams

OVERRIDES = dict()


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        REDQExperimentBuilder,
        offpolicy_training_config(args, batch_size=256,
                                  update_step_num_gradient_steps_per_sample=1.0),
        params=REDQParams(actor_lr=1e-3, critic_lr=1e-3, ensemble_size=10,
                          subset_size=2, actor_delay=20),
        with_actor_factory=ActorFactoryDefault(hidden_sizes=(256, 256), conditioned_sigma=True),
        with_critic_factory=CriticFactoryDefault(hidden_sizes=(256, 256), use_action=True),
    )


if __name__ == "__main__":
    main()
