"""GAIL inverse RL on Pendulum, the port of ``examples/inverse/irl_gail.py``
(analogue of the reference's examples/inverse/irl_gail.py): gather expert
transitions with SAC, then train PPO against a learned discriminator reward
only.

    python examples_torch/inverse/irl_gail.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg, setup
from examples_torch.offline._gather import gather_pendulum
from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.models.discrete import DiscreteCritic
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env, expert_obs, expert_act):
    return GAIL(
        actor=ContinuousActorProbabilistic(hidden_sizes=(64, 64), action_dim=1, input_dim=3),
        critic=DiscreteCritic(hidden_sizes=(64, 64), input_dim=3),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
        disc_net=ContinuousCritic(hidden_sizes=(64, 64), input_dim=3, action_dim=1),
        expert_obs=expert_obs, expert_act=expert_act,
        disc_optim=AdamOptimizerFactory(lr=1e-3), disc_update_num=2,
        gamma=0.95, gae_lambda=0.95, eps_clip=0.2, deterministic_eval=True,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev, gen = setup(args.device, 0)
    env, data, dstate, _, _ = gather_pendulum(gen)
    n = int(dstate.size.sum())
    flat = dstate.data.map(lambda x: x.reshape(-1, *x.shape[2:]))
    algo = make_algo(env, flat.obs[:n], flat.act[:n])
    ts = algo.init(dev)
    tc = DeviceCollector(VectorDeviceEnv(env, 16, device=dev), algo, None)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=dev), algo, None)
    res = OnPolicyTrainer(algo, tc, ec, OnPolicyTrainerParams(
        max_epochs=15, epoch_num_steps=10000, test_step_num_episodes=10,
        batch_size=128, collection_step_num_env_steps=64,
        update_step_num_repetitions=2, stop_fn=lambda r: r >= -300,
    )).run(ts, gen)
    print(f"GAIL: best_reward={res.best_reward:.1f}", flush=True)
    return res


if __name__ == "__main__":
    main()
