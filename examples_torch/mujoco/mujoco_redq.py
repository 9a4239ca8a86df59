"""REDQ on the port's MuJoCo-class envs, the port of examples/mujoco/mujoco_redq.py
(ensemble 10, subset 2, UTD 20, auto alpha).

    python examples_torch/mujoco/mujoco_redq.py --task Ant [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._runner import main_offpolicy, offpolicy_argparser

DEFAULTS = dict(start_steps=10_000)


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, EnsembleCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return REDQ(
        actor=ContinuousActorProbabilistic(hidden_sizes=(256, 256), action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=EnsembleCritic(10, (256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, tau=0.005,
        ensemble_size=10, subset_size=2, alpha="auto", actor_delay=20,
    )


def build_parser():
    return offpolicy_argparser(**DEFAULTS)


def main(argv=None):
    return main_offpolicy(make_algo, argv, **DEFAULTS)


if __name__ == "__main__":
    main()
