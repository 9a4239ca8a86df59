"""SAC on the port's MuJoCo-class envs through the declarative high-level API, the
port of ``examples/mujoco/mujoco_sac_hl.py`` (SACParams: 256x256 nets, lr 1e-3,
alpha 0.2, tau 0.005, 10k random prefill).

    python examples_torch/mujoco/mujoco_sac_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._hl import offpolicy_training_config, parse_args, run
from examples_torch.mujoco._hl import build_parser as _build_parser
from tianshou_tpu_torch.highlevel.experiment import SACExperimentBuilder
from tianshou_tpu_torch.highlevel.module import ActorFactoryDefault, CriticFactoryDefault
from tianshou_tpu_torch.highlevel.params import SACParams

OVERRIDES = dict()


def build_parser():
    return _build_parser(**OVERRIDES)


def main(argv=None):
    args = parse_args(argv, **OVERRIDES)
    return run(
        args,
        SACExperimentBuilder,
        offpolicy_training_config(args, batch_size=256,
                                  update_step_num_gradient_steps_per_sample=1.0),
        params=SACParams(actor_lr=1e-3, critic_lr=1e-3, alpha=0.2, tau=0.005),
        with_actor_factory=ActorFactoryDefault(hidden_sizes=(256, 256), conditioned_sigma=True),
        with_critic_factory=CriticFactoryDefault(hidden_sizes=(256, 256), use_action=True),
    )


if __name__ == "__main__":
    main()
