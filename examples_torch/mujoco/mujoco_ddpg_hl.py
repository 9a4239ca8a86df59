"""DDPG on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_ddpg_hl.py`` (DDPGParams, sigma 0.1).

    python examples_torch/mujoco/mujoco_ddpg_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import offpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import DDPGExperimentBuilder
from tianshou_tpu_torch.highlevel.module import ActorFactoryDefault, CriticFactoryDefault
from tianshou_tpu_torch.highlevel.params import DDPGParams

OVERRIDES = dict(start_steps=25_000)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        DDPGExperimentBuilder,
        offpolicy_training_config(args, batch_size=256,
                                  update_step_num_gradient_steps_per_sample=1.0),
        params=DDPGParams(actor_lr=1e-3, critic_lr=1e-3, exploration_noise=0.1),
        with_actor_factory=ActorFactoryDefault(hidden_sizes=(256, 256), continuous_deterministic=True),
        with_critic_factory=CriticFactoryDefault(hidden_sizes=(256, 256), use_action=True),
    )


if __name__ == "__main__":
    main()
