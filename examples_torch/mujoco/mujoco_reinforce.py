"""REINFORCE on the port's MuJoCo-class envs, the port of
``examples/mujoco/mujoco_reinforce.py`` (64x64 nets, lr 1e-3, discounted MC
returns with standardization).

    python examples_torch/mujoco/mujoco_reinforce.py --task Hopper [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from examples_torch.mujoco._runner import main_onpolicy, make_train, onpolicy_argparser


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.reinforce import Reinforce
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return Reinforce(
        actor=ContinuousActorProbabilistic(hidden_sizes=(64, 64), action_dim=nu, ppo_init=True, input_dim=obs_dim),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, return_standardization=True,
        action_bound_method="tanh", deterministic_eval=True,
    )


# reference protocol: ONE full-batch gradient step per 2048 collected steps
# (collection_step_num_env_steps=2048, update_step_num_repetitions=1,
# reference mujoco_reinforce.py:37-38): 16 envs x 128-step rollouts keep
# both the update cadence and long MC-return segments
DEFAULTS = dict(num_envs=16, rollout_len=128, batch_size=2048, repeat=1)
train = make_train(make_algo, **DEFAULTS)


def build_parser():
    return onpolicy_argparser(**DEFAULTS)


def main(argv=None):
    return main_onpolicy(make_algo, argv, **DEFAULTS)


if __name__ == "__main__":
    main()
