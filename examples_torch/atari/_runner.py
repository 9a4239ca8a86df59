"""Shared runner for the port's Atari example family (the twin of
``examples/atari/_runner.py``).

With ``ale-py`` installed the scripts train on the real Atari games through
the host path (the DeepMind wrapper stack of ``tianshou_tpu_torch.env.atari``,
numpy envs, the policy, replay and updates on the device). Without it the
fallback is ``SyntheticAtari``, a catch game rendered at 84x84 uint8 that is
solvable from pixels, and the whole pixel pipeline (uint8 frames in device
memory, ``save_only_last_obs`` with ``stack_num=4`` re-stacking at sample
time, the trainer's collect and update programs as CUDA graphs) trains on
the device. Either way the scripts print which env they run.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import torch
from torch import nn

from examples_torch.common import add_device_arg, setup, transition_example
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep, VectorDeviceEnv
from tianshou_tpu_torch.env.wrappers import FrameStack
from tianshou_tpu_torch.models.atari import NatureCNN
from tianshou_tpu_torch.models.mlp import _lecun_normal_

FRAME = (84, 84, 1)
STACK = 4
PER_ALPHA, PER_BETA = 0.6, 0.4  # the prioritized replay of atari_rainbow.py


class _SynthState(NamedTuple):
    pos: torch.Tensor   # [E] int32 paddle column [0, 20]
    ball: torch.Tensor  # [E] int32 ball column [0, 20]
    drop: torch.Tensor  # [E] int32 steps since this ball appeared (renders its row)
    t: torch.Tensor     # [E] int32 episode step counter (drives truncation)


class SyntheticAtari(Env):
    """Catch-style game rendered at 84x84 uint8: move the paddle (3 actions:
    stay/left/right) under the falling ball's column; +1 when aligned at the
    catch step, -0.2 otherwise. Solvable from pixels, episode length 200.

    The random draws (the paddle's and the ball's columns at reset, the next
    ball's column at a catch) are made in :meth:`reset` and :meth:`step`;
    :meth:`reset_from` and :meth:`step_from` take them as given."""

    cols = 21
    max_episode_steps = 200

    def __init__(self) -> None:
        self.observation_space = Box(low=0, high=255, shape=FRAME, dtype=torch.uint8)
        self.action_space = Discrete(3)

    def _obs(self, s: _SynthState) -> torch.Tensor:
        cell = 84 // self.cols  # 4 px per column
        px = torch.arange(84, dtype=torch.int32, device=s.pos.device)
        col_idx, row_idx = (px // cell)[None, None, :], px[None, :, None]
        ball_row = s.drop * 80 // 40  # falls over 40 steps
        ball = (col_idx == s.ball[:, None, None]) & (row_idx // cell == (ball_row // cell)[:, None, None])
        paddle = (col_idx == s.pos[:, None, None]) & (row_idx >= 80)
        return ((ball | paddle).to(torch.uint8) * 255)[..., None]

    def reset_from(self, pos: torch.Tensor, ball: torch.Tensor) -> tuple[_SynthState, torch.Tensor]:
        zero = torch.zeros_like(pos, dtype=torch.int32)
        s = _SynthState(pos.to(torch.int32), ball.to(torch.int32), zero, zero.clone())
        return s, self._obs(s)

    def reset(self, num_envs, generator, device):
        pos, ball = torch.randint(0, self.cols, (2, num_envs), generator=generator, device=device, dtype=torch.int32)
        return self.reset_from(pos, ball)

    def step_from(self, state: _SynthState, action: torch.Tensor, new_ball: torch.Tensor) -> EnvStep:
        move = torch.where(action == 1, -1, torch.where(action == 2, 1, 0))
        pos = (state.pos + move).clamp(0, self.cols - 1).to(torch.int32)
        drop = state.drop + 1
        catch = drop >= 40  # the ball lands every 40 steps, then re-drops
        aligned = pos == state.ball
        rew = torch.where(catch, torch.where(aligned, 1.0, -0.2), 0.0).to(torch.float32)
        s = _SynthState(pos, torch.where(catch, new_ball.to(torch.int32), state.ball),
                        torch.where(catch, 0, drop).to(torch.int32), state.t + 1)
        return EnvStep(
            state=s, obs=self._obs(s), reward=rew,
            terminated=torch.zeros_like(catch),  # fixed horizon: truncation only
            truncated=s.t >= self.max_episode_steps,
            info=Batch(),
        )

    def step(self, state, action, generator):
        new_ball = torch.randint(0, self.cols, state.ball.shape, generator=generator, device=state.ball.device,
                                 dtype=torch.int32)
        return self.step_from(state, action, new_ball)


def build_parser(**overrides) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default=overrides.get("task", "PongNoFrameskip-v4"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=overrides.get("lr", 1e-4))
    p.add_argument("--epochs", type=int, default=overrides.get("epochs", 20))
    p.add_argument("--epoch-num-steps", type=int, default=overrides.get("epoch_num_steps", 20_000))
    p.add_argument("--num-envs", type=int, default=overrides.get("num_envs", 16))
    p.add_argument("--buffer-size", type=int, default=overrides.get("buffer_size", 100_000))
    p.add_argument("--batch-size", type=int, default=overrides.get("batch_size", 32))
    p.add_argument("--start-steps", type=int, default=overrides.get("start_steps", 2_000))
    return add_device_arg(p)


def parse_args(argv=None, **overrides) -> argparse.Namespace:
    return build_parser(**overrides).parse_args(argv)


def ale_actions(task: str) -> int | None:
    """The action count of the real ALE game ``task``, or None where ale-py or its ROMs are absent."""
    from tianshou_tpu_torch.env.atari import make_atari_env

    try:
        probe = make_atari_env(task)
    except ImportError:
        return None
    n = int(probe.action_space.n)
    if hasattr(probe, "close"):
        probe.close()
    return n


def n_actions(args) -> int:
    """Action count for the task (real ALE) or the synthetic fallback."""
    n = ale_actions(args.task)
    return 3 if n is None else n


def say_fallback(task: str) -> None:
    print(f"[atari] {task}: no ALE game here (ale-py and the ROMs); the synthetic catch game (SyntheticAtari) "
          "on the device instead", flush=True)


def make_buffer(args, prioritized: bool = False, host: bool = False):
    """The uint8 frame ring: frames stored once, stacked at sample time; ``prioritized``: PER."""
    ring = dict(total_size=args.buffer_size, buffer_num=args.num_envs, stack_num=STACK, save_only_last_obs=True)
    if host:
        ring["ignore_obs_next"] = True
    if prioritized:
        return PrioritizedVectorReplayBuffer(alpha=PER_ALPHA, beta=PER_BETA, **ring)
    return VectorReplayBuffer(**ring)


def frame_example(frame: tuple[int, ...]) -> Batch:
    return transition_example(torch.zeros(frame, dtype=torch.uint8), torch.tensor(0))


def run_offpolicy(args, algo, stop_reward: float = 4.0, prioritized: bool = False):
    """Train an off-policy pixel algorithm: the host path on real ALE, the
    device path on the synthetic game (n-step 3, eps decay 1 -> 0.05, frames
    stored once, stacked on sample). ``prioritized`` samples through a
    prioritized replay (alpha 0.6, beta 0.4)."""
    if ale_actions(args.task) is not None:
        return _run_offpolicy_host(args, algo, prioritized)
    say_fallback(args.task)
    return _run_offpolicy_device(args, algo, stop_reward, prioritized)


def _run_offpolicy_device(args, algo, stop_reward: float, prioritized: bool = False):
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    device, gen = setup(args.device, args.seed)
    env = FrameStack(SyntheticAtari(), STACK)
    ts = algo.init(device)
    buffer = make_buffer(args, prioritized)
    buf_state = buffer.init(frame_example(FRAME), device=device)
    tc = DeviceCollector(VectorDeviceEnv(env, args.num_envs, device=device), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 8, device=device), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
        test_step_num_episodes=8, batch_size=args.batch_size,
        collection_step_num_env_steps=10, update_per_step=0.1,
        start_steps=args.start_steps,
        stop_fn=lambda r: r >= stop_reward,
        train_fn=lambda ep, step: {"eps_training": max(0.05, 1.0 - step / 100_000)},
        verbose=True, seed=args.seed,
    )
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.2f} env_steps={res.env_step}", flush=True)
    return res


def _run_offpolicy_host(args, algo, prioritized: bool = False):
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.atari import make_atari_env
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainerParams

    def factory():
        return make_atari_env(args.task)

    device, gen = setup(args.device, args.seed)
    ts = algo.init(device)
    buffer = make_buffer(args, prioritized, host=True)
    buf_state = buffer.init(frame_example(FRAME[:2]), device=device)  # the host stack is [4, 84, 84]: one frame a row
    tc = HostCollector(DummyVectorEnv([factory for _ in range(args.num_envs)]), algo, buffer, device=device)
    ec = HostCollector(DummyVectorEnv([factory for _ in range(10)]), algo, None, device=device)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=100_000, test_step_num_episodes=10,
        batch_size=args.batch_size, collection_step_num_env_steps=10, update_per_step=0.1,
        start_steps=max(args.start_steps, 50_000),
        train_fn=lambda ep, step: {"eps_training": max(0.05, 1.0 - step / 1_000_000)},
        verbose=True, seed=args.seed,
    )
    res = HostOffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} env_steps={res.env_step}", flush=True)
    return res


def run_onpolicy(args, algo, stop_reward: float = 4.0):
    """Train an on-policy pixel algorithm on the device path (reference
    atari_ppo.py). As in the JAX script, no host-ALE variant: the synthetic
    game always."""
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    print("[atari] on-policy: the synthetic catch game (SyntheticAtari) on the device", flush=True)
    device, gen = setup(args.device, args.seed)
    env = FrameStack(SyntheticAtari(), STACK)
    ts = algo.init(device)
    tc = DeviceCollector(VectorDeviceEnv(env, args.num_envs, device=device), algo, None)
    ec = DeviceCollector(VectorDeviceEnv(env, 8, device=device), algo, None)
    params = OnPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=args.epoch_num_steps,
        test_step_num_episodes=8, batch_size=args.batch_size,
        collection_step_num_env_steps=128, update_step_num_repetitions=4,
        stop_fn=lambda r: r >= stop_reward,
        verbose=True, seed=args.seed,
    )
    res = OnPolicyTrainer(algo, tc, ec, params).run(ts, gen)
    print(f"best_reward={res.best_reward:.2f} env_steps={res.env_step}", flush=True)
    return res


class PixelCritic(nn.Module):
    """NatureCNN -> scalar value ``[B]`` (the actor-critic pixel head); the
    head a float32 ``Linear`` as in :class:`tianshou_tpu_torch.models.atari.DQNet`."""

    def __init__(self, features: int = 512, in_channels: int = STACK) -> None:
        super().__init__()
        self.cnn = NatureCNN(in_channels, features)
        self.head = nn.Linear(features, 1)
        _lecun_normal_(self.head.weight, features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.cnn(x))[:, 0]
