"""SAC on the device Pendulum, the port of ``examples/continuous/sac_pendulum.py``
(analogue of the reference's examples/mujoco/mujoco_sac.py on the built-in
Pendulum; swap in any Env implementation).

    python examples_torch/continuous/sac_pendulum.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def make_algo(env):
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1, conditioned_sigma=True,
                                           input_dim=3),
        critic=ContinuousCritic(hidden_sizes=(128, 128), input_dim=3, action_dim=1),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=3e-4),
        critic_optim=AdamOptimizerFactory(lr=3e-4),
        gamma=0.99, tau=0.005, alpha="auto",
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, gen = setup(args.device, 0)
    env = Pendulum()
    algo = make_algo(env)
    ts = algo.init(device)
    buffer = VectorReplayBuffer(total_size=50000, buffer_num=8)
    buf_state = buffer.init(transition_example(torch.zeros(3), torch.zeros(1)), device=device)
    tc = DeviceCollector(VectorDeviceEnv(env, 8, device=device), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device=device), algo, None)
    res = OffPolicyTrainer(algo, tc, ec, buffer, OffPolicyTrainerParams(
        max_epochs=10, epoch_num_steps=4000, batch_size=128,
        collection_step_num_env_steps=8, update_per_step=0.5,
        start_steps=2000, start_random=False, stop_fn=lambda r: r >= -250,
    )).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} alpha={float(res.train_state.model.log_alpha.detach().exp()):.3f}", flush=True)
    return res


if __name__ == "__main__":
    main()
