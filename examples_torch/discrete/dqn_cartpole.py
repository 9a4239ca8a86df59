"""DQN on the device CartPole through the low-level API, the port of
``examples/discrete/dqn_cartpole.py`` (analogue of the reference's
test/discrete/test_dqn.py / examples/atari/atari_dqn.py structure).

    python examples_torch/discrete/dqn_cartpole.py [--device cpu] [--logdir log/dqn]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams


def make_algo(args, env):
    return DQN(
        model=Net(hidden_sizes=(64, 64), output_dim=2, input_dim=4),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=args.lr),
        gamma=args.gamma,
        n_step_return_horizon=3,
        target_update_freq=320,
        eps_training=0.3,
    )


def run(args, algo, env, device, generator):
    """The JAX script's training: 10 test envs, epochs of 5,000 steps, batch 64, T 10, 0.1 updates per step,
    a 1,000-step prefill, eps annealed from 0.3 to 0.1 over 30,000 steps, stop at 195."""
    ts = algo.init(device)
    buffer = VectorReplayBuffer(total_size=args.buffer_size, buffer_num=args.num_envs)
    buf_state = buffer.init(transition_example(torch.zeros(4), torch.tensor(0)), device=device)
    train_c = DeviceCollector(VectorDeviceEnv(env, args.num_envs, device=device), algo, buffer)
    test_c = DeviceCollector(VectorDeviceEnv(env, 10, device=device), algo, None)

    logger = None
    if args.logdir:
        from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger

        logger = TensorboardLogger(log_dir=args.logdir)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=5000, test_step_num_episodes=10,
        batch_size=64, collection_step_num_env_steps=10, update_per_step=0.1,
        start_steps=1000,
        stop_fn=lambda r: r >= 195,
        train_fn=lambda ep, step: {"eps_training": max(0.1, 0.3 * (1 - step / 30000))},
        logger=logger,
    )
    result = OffPolicyTrainer(algo, train_c, test_c, buffer, params).run(ts, buf_state, generator)
    print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
          f"time={result.train_time:.1f}s timing={result.timing}", flush=True)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.97)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--buffer-size", type=int, default=20000)
    p.add_argument("--logdir", type=str, default=None)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, gen = setup(args.device, args.seed)
    env = CartPole()
    return run(args, make_algo(args, env), env, device, gen)


if __name__ == "__main__":
    main()
