"""PPO on the port's MuJoCo-class envs, the port of ``examples/mujoco/mujoco_ppo.py``.

Hyperparameters follow the reference where they transfer (net sizes, lr +
linear decay, gamma/gae, clip/value-clip, obs normalization). ``--sde``
switches exploration to gSDE.

    python examples_torch/mujoco/mujoco_ppo.py --task HalfCheetah --epochs 30 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg
from examples_torch.mujoco._runner import add_backend_args, run_onpolicy, run_onpolicy_host, script_kwargs


def _schedule(lr, lr_decay, epochs, epoch_num_steps, num_envs, rollout_len, repeat, batch_size):
    """The rate: ``lr`` decayed linearly over the run's MINIBATCH gradient steps (rollouts x repeat x
    minibatches per pass), or constant."""
    from tianshou_tpu_torch.algorithm.optim import linear_lr_schedule

    n_rollouts = max(1, epochs * epoch_num_steps // (num_envs * rollout_len))
    n_minibatches = max(1, (num_envs * rollout_len) // batch_size)
    return linear_lr_schedule(lr, n_rollouts * repeat * n_minibatches) if lr_decay else lr


def make_ppo(env, lr, hidden=(64, 64), gamma=0.99, gae_lambda=0.95, target_kl=0.015, ent_coef=0.0, sde=False,
             sde_sigma_init=-2.0):
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return PPO(
        # reference init recipe (mujoco_ppo.py:109-120): tanh nets,
        # orthogonal kernels, 0.01-scaled final mu layer, sigma exp(-0.5).
        # sde=True switches exploration to gSDE (arXiv:2005.05719):
        # temporally-correlated state-dependent noise, resampled per rollout
        # and on episode end.
        actor=ContinuousActorProbabilistic(
            hidden_sizes=hidden, action_dim=nu, ppo_init=True,
            sde=sde, sigma_init=(sde_sigma_init if sde else -0.5), input_dim=obs_dim,
        ),
        critic=ContinuousCritic(hidden_sizes=hidden, use_action=False, ppo_init=True, input_dim=obs_dim),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=lr, max_grad_norm=0.5),
        gamma=gamma,
        gae_lambda=gae_lambda,
        eps_clip=0.2,
        value_clip=True,
        advantage_normalization=False,
        return_standardization=True,
        recompute_advantage=True,
        vf_coef=0.25,
        ent_coef=ent_coef,
        action_bound_method="clip",
        deterministic_eval=True,
        target_kl=target_kl,
    )


def train(
    task: str = "HalfCheetah",
    seed: int = 0,
    epochs: int = 30,
    epoch_num_steps: int = 100_000,
    num_envs: int = 16,
    rollout_len: int = 128,   # 2048 steps per collect (reference protocol)
    repeat: int = 10,
    batch_size: int = 64,
    lr: float = 3e-4,
    lr_decay: bool = True,
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    target_kl: float | None = 0.015,
    ent_coef: float = 0.0,
    sde: bool = False,
    sde_sigma_init: float = -2.0,
    hidden: tuple = (64, 64),
    test_episodes: int = 10,
    logger=None,
    verbose: bool = True,
    device=None,
):
    # obs normalization, frozen on the test envs (reference update_obs_rms=False)
    sched = _schedule(lr, lr_decay, epochs, epoch_num_steps, num_envs, rollout_len, repeat, batch_size)
    return run_onpolicy(
        lambda env: make_ppo(env, sched, hidden, gamma, gae_lambda, target_kl, ent_coef, sde, sde_sigma_init),
        task, seed, epochs, epoch_num_steps, num_envs, rollout_len, repeat, batch_size, norm_obs=True,
        test_episodes=test_episodes, verbose=verbose, logger=logger, device=device,
    )


def train_host(task="HalfCheetah", seed=0, epochs=30, epoch_num_steps=100_000,
               num_envs=16, rollout_len=128, repeat=10, batch_size=64,
               lr=3e-4, lr_decay=True, hidden=(64, 64), test_episodes=10,
               verbose=True, logger=None, device=None, **_ignored):
    """PPO on the REAL Gymnasium MuJoCo envs (reference protocol)."""
    sched = _schedule(lr, lr_decay, epochs, epoch_num_steps, num_envs, rollout_len, repeat, batch_size)
    return run_onpolicy_host(
        lambda env: make_ppo(env, sched, hidden, target_kl=None), task=task, seed=seed, epochs=epochs,
        epoch_num_steps=epoch_num_steps, num_envs=num_envs,
        batch_size=batch_size, rollout_len=rollout_len, repeat=repeat,
        test_episodes=test_episodes, verbose=verbose, logger=logger, device=device,
    )


def build_parser() -> argparse.ArgumentParser:
    p = add_backend_args(argparse.ArgumentParser())
    p.add_argument("--task", default="HalfCheetah")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--epoch-num-steps", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--rollout-len", type=int, default=128)
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--sde", action="store_true", help="gSDE state-dependent exploration (device backend)")
    return add_device_arg(p)


def main(argv=None):
    kw = script_kwargs(build_parser().parse_args(argv))
    return (train_host if kw.pop("backend") == "host" else train)(**kw)


if __name__ == "__main__":
    main()
