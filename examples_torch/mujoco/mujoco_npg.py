"""NPG on the port's MuJoCo-class envs, the port of ``examples/mujoco/mujoco_npg.py``
(natural gradient via conjugate gradient, 64x64 nets).

    python examples_torch/mujoco/mujoco_npg.py --task HalfCheetah [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._runner import main_onpolicy, make_train, onpolicy_argparser


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return NPG(
        actor=ContinuousActorProbabilistic(hidden_sizes=(64, 64), action_dim=nu, ppo_init=True, input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(64, 64), use_action=False, ppo_init=True, input_dim=obs_dim),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, gae_lambda=0.95,
        trust_region_size=0.5, optim_critic_iters=20,
        action_bound_method="clip", deterministic_eval=True,
    )


# reference cadence: ONE natural-gradient step per 1024 collected steps over
# 16 envs (collection_step_num_env_steps=1024, reference mujoco_npg.py:37)
DEFAULTS = dict(rollout_len=64, batch_size=16384, repeat=1, num_envs=16)
train = make_train(make_algo, **DEFAULTS)


def build_parser():
    return onpolicy_argparser(**DEFAULTS)


def main(argv=None):
    return main_onpolicy(make_algo, argv, **DEFAULTS)


if __name__ == "__main__":
    main()
