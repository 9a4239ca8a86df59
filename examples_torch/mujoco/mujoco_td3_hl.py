"""TD3 on the port's MuJoCo-class envs through the high-level API, the port of
``examples/mujoco/mujoco_td3_hl.py`` (TD3Params: twin critics, policy smoothing 0.2
clipped at 0.5, actor delay 2, sigma 0.1).

    python examples_torch/mujoco/mujoco_td3_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import offpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import TD3ExperimentBuilder
from tianshou_tpu_torch.highlevel.module import ActorFactoryDefault, CriticFactoryDefault
from tianshou_tpu_torch.highlevel.params import TD3Params

OVERRIDES = dict(start_steps=25_000)


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        TD3ExperimentBuilder,
        offpolicy_training_config(args, batch_size=256,
                                  update_step_num_gradient_steps_per_sample=1.0),
        params=TD3Params(actor_lr=3e-4, critic_lr=3e-4, exploration_noise=0.1,
                         policy_noise=0.2, noise_clip=0.5, update_actor_freq=2),
        with_actor_factory=ActorFactoryDefault(hidden_sizes=(256, 256), continuous_deterministic=True),
        with_critic_factory=CriticFactoryDefault(hidden_sizes=(256, 256), use_action=True),
    )


if __name__ == "__main__":
    main()
