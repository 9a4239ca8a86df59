"""C51 on ViZDoom, the port of ``examples/vizdoom/vizdoom_c51.py`` (51 atoms
on [-10, 10], n-step 3, target sync 500, eps 1 -> 0.05). With the vizdoom
package present it trains on the real scenario through the host path;
otherwise on the synthetic device stand-in with the same pixel contract
(``env.py``).

    python examples_torch/vizdoom/vizdoom_c51.py --task D1_basic [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.common import add_device_arg, setup, transition_example
from examples_torch.vizdoom.env import RES, STACK, make_collectors, make_vizdoom_env
from tianshou_tpu_torch.algorithm.modelfree.c51 import C51
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env.core import Discrete, VectorDeviceEnv
from tianshou_tpu_torch.models.atari import C51Net

TASKS = ["D1_basic", "D2_navigation", "D3_battle", "D4_battle2"]


def make_algo(n: int, lr: float) -> C51:
    return C51(
        model=C51Net(action_dim=n, num_atoms=51, input_hw=RES[:2]),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=lr),
        num_atoms=51, v_min=-10.0, v_max=10.0,
        gamma=0.99, n_step_return_horizon=3, target_update_freq=500,
        eps_training=1.0, eps_inference=0.005,
    )


def train(task: str = "D1_basic", seed: int = 0, epochs: int = 20,
          epoch_num_steps: int = 20_000, num_envs: int = 16,
          buffer_size: int = 100_000, batch_size: int = 64,
          lr: float = 1e-4, logger=None, start_steps: int = 2_000, device=None):
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainer, OffPolicyTrainerParams

    dev, gen = setup(device, seed)  # raises without a GPU unless device is cpu; seeds the nets' weights
    env, train_envs, test_envs = make_vizdoom_env(task, num_training_envs=num_envs, device=dev)
    algo = make_algo(env.action_space.n, lr)
    ts = algo.init(dev)
    on_device = isinstance(train_envs, VectorDeviceEnv)
    # frames stored once and stacked at sample time; the host stack is [4, 40, 60], one frame a row
    buffer = VectorReplayBuffer(total_size=buffer_size, buffer_num=num_envs, stack_num=STACK,
                                save_only_last_obs=True, ignore_obs_next=not on_device)
    frame = RES if on_device else RES[:2]
    buf_state = buffer.init(transition_example(torch.zeros(frame, dtype=torch.uint8), torch.tensor(0)), device=dev)
    tc, ec = make_collectors(train_envs, test_envs, algo, buffer, dev)
    params = OffPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=8, batch_size=batch_size,
        collection_step_num_env_steps=10, update_per_step=0.1,
        start_steps=start_steps,
        train_fn=lambda ep, step: {"eps_training": max(0.05, 1.0 - step / 100_000)},
        verbose=True, seed=seed, logger=logger,
    )
    trainer = OffPolicyTrainer if on_device else HostOffPolicyTrainer
    res = trainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"vizdoom C51 {task}: best_reward={res.best_reward:.2f} env_steps={res.env_step}", flush=True)
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="D1_basic", choices=TASKS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--epoch-num-steps", type=int, default=20_000)
    p.add_argument("--lr", type=float, default=1e-4)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    return train(task=args.task, seed=args.seed, epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
                 lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
