"""DDPG on the port's MuJoCo-class envs, the port of examples/mujoco/mujoco_ddpg.py
(256x256 nets, lr 1e-3, gaussian exploration sigma 0.1, 25k random prefill).

    python examples_torch/mujoco/mujoco_ddpg.py --task HalfCheetah [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._runner import main_offpolicy, offpolicy_argparser

DEFAULTS = dict(start_steps=25_000)


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.exploration.noise import GaussianNoise
    from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return DDPG(
        actor=ContinuousActorDeterministic(hidden_sizes=(256, 256), action_dim=nu, input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, tau=0.005, exploration_noise=GaussianNoise(sigma=0.1),
    )


def build_parser():
    return offpolicy_argparser(**DEFAULTS)


def main(argv=None):
    return main_offpolicy(make_algo, argv, **DEFAULTS)


if __name__ == "__main__":
    main()
