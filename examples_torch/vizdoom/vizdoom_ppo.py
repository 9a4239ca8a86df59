"""PPO on ViZDoom pixels, the port of ``examples/vizdoom/vizdoom_ppo.py``
(NatureCNN actor and critic, clip 0.2, GAE 0.95). The real scenario through
the host path when vizdoom is installed; the synthetic device stand-in
otherwise (``env.py``).

    python examples_torch/vizdoom/vizdoom_ppo.py --task D1_basic [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch
from torch import nn

from examples_torch.common import add_device_arg, setup
from examples_torch.vizdoom.env import RES, STACK, make_collectors, make_vizdoom_env
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Discrete, VectorDeviceEnv
from tianshou_tpu_torch.models.atari import NatureCNN
from tianshou_tpu_torch.models.mlp import _lecun_normal_

TASKS = ["D1_basic", "D2_navigation", "D3_battle", "D4_battle2"]


class PixelActor(nn.Module):
    """NatureCNN -> logits through a float32 ``Linear`` (the JAX script's ``PixelActor``: ``NatureCNN_0``,
    ``Dense_0``)."""

    def __init__(self, action_dim: int, features: int = 512, in_channels: int = STACK,
                 compute_dtype: torch.dtype = torch.bfloat16, input_hw: tuple[int, int] = RES[:2]) -> None:
        super().__init__()
        self.cnn = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.head = nn.Linear(features, action_dim)
        _lecun_normal_(self.head.weight, features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.cnn(x))


class PixelCritic(nn.Module):
    """NatureCNN @ ``w [features, 1]``, no bias, lecun-normal (the JAX script's ``PixelCritic``: ``NatureCNN_0``,
    ``w``): values ``[B, 1]``, which the algorithm reshapes to ``[B]``."""

    def __init__(self, features: int = 512, in_channels: int = STACK,
                 compute_dtype: torch.dtype = torch.bfloat16, input_hw: tuple[int, int] = RES[:2]) -> None:
        super().__init__()
        self.cnn = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.w = nn.Parameter(torch.empty(features, 1))
        _lecun_normal_(self.w, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x) @ self.w


def make_algo(n: int, lr: float) -> PPO:
    return PPO(
        actor=PixelActor(action_dim=n),
        critic=PixelCritic(),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=lr, max_grad_norm=0.5),
        gamma=0.99, gae_lambda=0.95, eps_clip=0.2, vf_coef=0.5, ent_coef=0.01,
    )


def train(task: str = "D1_basic", seed: int = 0, epochs: int = 20,
          epoch_num_steps: int = 20_000, num_envs: int = 16,
          batch_size: int = 256, lr: float = 2.5e-4, logger=None, device=None):
    from tianshou_tpu_torch.trainer.trainer import HostOnPolicyTrainer, OnPolicyTrainer, OnPolicyTrainerParams

    dev, gen = setup(device, seed)  # raises without a GPU unless device is cpu; seeds the nets' weights
    env, train_envs, test_envs = make_vizdoom_env(task, num_training_envs=num_envs, device=dev)
    algo = make_algo(env.action_space.n, lr)
    ts = algo.init(dev)
    tc, ec = make_collectors(train_envs, test_envs, algo, None, dev)
    params = OnPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=8, batch_size=batch_size,
        collection_step_num_env_steps=128, update_step_num_repetitions=4,
        verbose=True, seed=seed, logger=logger,
    )
    trainer = OnPolicyTrainer if isinstance(train_envs, VectorDeviceEnv) else HostOnPolicyTrainer
    res = trainer(algo, tc, ec, params).run(ts, gen)
    print(f"vizdoom PPO {task}: best_reward={res.best_reward:.2f} env_steps={res.env_step}", flush=True)
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="D1_basic", choices=TASKS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--epoch-num-steps", type=int, default=20_000)
    p.add_argument("--lr", type=float, default=2.5e-4)
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    return train(task=args.task, seed=args.seed, epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
                 lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
