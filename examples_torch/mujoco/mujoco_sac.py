"""SAC on the port's MuJoCo-class envs, the port of ``examples/mujoco/mujoco_sac.py``
(256x256 nets, lr 1e-3, tau 0.005, alpha 0.2 fixed by default, 10k random
prefill, 1 gradient step per env step). Each collect chunk and its
gradient-step burst run as one program (one CUDA graph on the card).

    python examples_torch/mujoco/mujoco_sac.py --task HalfCheetah --epochs 50 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg
from examples_torch.mujoco._runner import add_backend_args, run_offpolicy, run_offpolicy_host, script_kwargs


def make_sac(env, hidden=(256, 256), actor_lr=1e-3, critic_lr=1e-3, alpha=0.2, tau=0.005, gamma=0.99, n_step=1):
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=hidden, action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=hidden, input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=actor_lr),
        critic_optim=AdamOptimizerFactory(lr=critic_lr),
        alpha=alpha,
        tau=tau,
        gamma=gamma,
        n_step_return_horizon=n_step,
    )


def train(
    task: str = "HalfCheetah",
    seed: int = 0,
    epochs: int = 50,
    epoch_num_steps: int = 20_000,
    num_envs: int = 32,
    chunk_len: int = 4,
    update_per_step: float = 1.0,
    batch_size: int = 256,
    buffer_size: int = 1_000_000,
    actor_lr: float = 1e-3,
    critic_lr: float = 1e-3,
    alpha: float | str = 0.2,
    tau: float = 0.005,
    gamma: float = 0.99,
    n_step: int = 1,
    start_steps: int = 10_000,
    hidden: tuple = (256, 256),
    test_episodes: int = 10,
    logger=None,
    verbose: bool = True,
    fused: bool = True,
    device=None,
):
    return run_offpolicy(
        lambda env: make_sac(env, hidden, actor_lr, critic_lr, alpha, tau, gamma, n_step), task, seed, epochs,
        epoch_num_steps, num_envs, batch_size, start_steps, buffer_size, chunk_len, update_per_step, test_episodes,
        verbose, logger, device, fused,
    )


def build_parser() -> argparse.ArgumentParser:
    p = add_backend_args(argparse.ArgumentParser())
    p.add_argument("--task", default="HalfCheetah")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--epoch-num-steps", type=int, default=20_000)
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--alpha", default=0.2)
    p.add_argument("--start-steps", type=int, default=10_000)
    return add_device_arg(p)


def main(argv=None):
    kw = script_kwargs(build_parser().parse_args(argv))
    if kw["alpha"] != "auto":
        kw["alpha"] = float(kw["alpha"])
    if kw.pop("backend") == "host":
        alpha = kw.pop("alpha")
        return run_offpolicy_host(lambda env: make_sac(env, alpha=alpha), **kw)
    return train(**kw)


if __name__ == "__main__":
    main()
