"""A2C on the port's MuJoCo-class envs, the port of ``examples/mujoco/mujoco_a2c.py``
(64x64 nets, GAE 0.95, vf_coef 0.25, obs normalization).

    python examples_torch/mujoco/mujoco_a2c.py --task Walker2d [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._runner import main_onpolicy, make_train, onpolicy_argparser


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return A2C(
        actor=ContinuousActorProbabilistic(hidden_sizes=(64, 64), action_dim=nu, ppo_init=True, input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(64, 64), use_action=False, ppo_init=True, input_dim=obs_dim),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=7e-4, max_grad_norm=0.5),
        gamma=0.99, gae_lambda=0.95, vf_coef=0.25, ent_coef=0.001,
        action_bound_method="clip", deterministic_eval=True,
    )


# reference cadence: one full-batch update per 80 collected steps over 16
# envs (collection_step_num_env_steps=80, reference mujoco_a2c.py:38)
DEFAULTS = dict(rollout_len=5, batch_size=4096, repeat=1, num_envs=16)
train = make_train(make_algo, **DEFAULTS)


def build_parser():
    return onpolicy_argparser(**DEFAULTS)


def main(argv=None):
    return main_onpolicy(make_algo, argv, **DEFAULTS)


if __name__ == "__main__":
    main()
