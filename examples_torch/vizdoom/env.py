"""ViZDoom environment layer, the port of ``examples/vizdoom/env.py`` (the
reference's examples/vizdoom/env.py: ``Env``:45, button combos :20-42,
``make_vizdoom_env``:136).

With the ``vizdoom`` package installed the scripts play the real Doom
scenarios through the host path (``DoomGame``, frameskip, the reference's
health / killcount / ammo reward shaping) as numpy envs in subprocesses.
Without it the fallback is :class:`SyntheticDoom`, a first-person "turn
toward the medikit and walk into it" game rendered at the reference's
40x60 resolution on the device, with the same observation contract
(``[4, 40, 60, 1]`` uint8 under ``FrameStack``) and the same 6 actions (the
normal button combinations).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep, VectorDeviceEnv
from tianshou_tpu_torch.env.wrappers import FrameStack
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["RES", "STACK", "SyntheticDoom", "VizdoomEnv", "battle_button_comb", "make_collectors",
           "make_vizdoom_env", "normal_button_comb"]

RES = (40, 60, 1)
STACK = 4


def normal_button_comb() -> list:
    """6 = {stay, forward} x {no-turn, left, right} (reference env.py:20)."""
    actions = []
    for fwd in ([0.0], [1.0]):
        for turn in ([0.0, 0.0], [0.0, 1.0], [1.0, 0.0]):
            actions.append(fwd + turn)
    return actions


def battle_button_comb() -> list:
    """108 battle-mode combos: attack x speed x strafe x move x turn (reference env.py:29)."""
    actions = []
    for attack in ([0.0], [1.0]):
        for speed in ([0.0], [1.0]):
            for strafe in ([0.0, 0.0], [0.0, 1.0], [1.0, 0.0]):
                for move in ([0.0, 0.0], [0.0, 1.0], [1.0, 0.0]):
                    for turn in ([0.0, 0.0], [0.0, 1.0], [1.0, 0.0]):
                        actions.append(move + strafe + turn + attack + speed)
    return actions


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize without cv2, for the host adapter."""
    ri = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    ci = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ri][:, ci]


class _HostDiscrete(Discrete):
    """The host adapter's action space: a ``Discrete`` whose ``sample()`` without arguments draws one action on the
    host from numpy's global generator, as a Gymnasium space draws one (the host collector's random prefill calls it
    so); with arguments it samples on a device as every ``Discrete`` does."""

    def sample(self, num=None, generator=None, device=None):
        if num is None:
            return int(np.random.randint(self.n))
        return super().sample(num, generator, device)


class VizdoomEnv:
    """Host adapter over ``vizdoom.DoomGame`` (reference env.py:45): frameskip,
    a rolling ``[C, H, W]`` uint8 screen buffer, the reward shaped from the
    health, killcount and ammo deltas. Needs the optional ``vizdoom`` package."""

    def __init__(self, cfg_path: str, frameskip: int = 4, res=(4, 40, 60), save_lmp: bool = False):
        try:
            import vizdoom as vzd
        except ImportError as e:
            raise ImportError("vizdoom is not installed") from e
        self._vzd = vzd
        self.res = res
        self.skip = frameskip
        self.save_lmp = save_lmp
        self.health_setting = "battle" in cfg_path
        self.game = vzd.DoomGame()
        self.game.load_config(cfg_path)
        self.game.init()
        self.available_actions = battle_button_comb() if "battle" in cfg_path else normal_button_comb()
        self.observation_space = Box(low=0, high=255, shape=res, dtype=torch.uint8)
        self.action_space = _HostDiscrete(len(self.available_actions))
        self.count = 0

    def _push_frame(self) -> None:
        state = self.game.get_state()
        if state is None:
            return
        frame = _resize_nearest(np.asarray(state.screen_buffer), self.res[-2], self.res[-1])
        self.obs_buffer[:-1] = self.obs_buffer[1:]
        self.obs_buffer[-1] = frame

    def _vars(self):
        gv = self._vzd.GameVariable
        return (self.game.get_game_variable(gv.HEALTH),
                self.game.get_game_variable(gv.KILLCOUNT),
                self.game.get_game_variable(gv.AMMO2))

    def reset(self, seed=None, **kwargs):
        if seed is not None:
            self.game.set_seed(seed)
        if self.save_lmp:
            self.game.new_episode(f"lmps/episode_{self.count}.lmp")
        else:
            self.game.new_episode()
        self.count += 1
        self.obs_buffer = np.zeros(self.res, np.uint8)
        self._push_frame()
        self.health, self.killcount, self.ammo2 = self._vars()
        return self.obs_buffer, {}

    def step(self, action: int):
        self.game.make_action(self.available_actions[int(action)], self.skip)
        self._push_frame()
        health, killcount, ammo2 = self._vars()
        reward = 20.0 * (killcount - self.killcount) + (ammo2 - self.ammo2)
        if self.health_setting or health > self.health:
            # positive-only health reward outside battle maps (reference env.py:104)
            reward += health - self.health
        self.health, self.killcount, self.ammo2 = health, killcount, ammo2
        dead = self.game.is_player_dead() or self.game.get_state() is None
        finished = self.game.is_episode_finished()
        terminated = bool(dead)
        truncated = bool(finished and not dead)
        return self.obs_buffer, float(reward), terminated, truncated, {}

    def render(self):
        pass

    def close(self):
        self.game.close()


class _DoomState(NamedTuple):
    heading: torch.Tensor  # [E] int32 agent yaw in [0, 36)
    target: torch.Tensor   # [E] int32 medikit bearing, same units
    dist: torch.Tensor     # [E] int32 distance to the medikit, 25 down to 1
    t: torch.Tensor        # [E] int32 episode step counter (drives truncation)


class SyntheticDoom(Env):
    """Device stand-in with the reference scenario's observation and action
    contract: a medikit column is drawn at its bearing relative to the
    agent's heading; turn (left / right) to centre it, then move forward to
    collect it (+1, like D1_basic's health pickups). A fixed 200-step horizon.

    The random draws (the heading and the target at reset, the next target at
    a pickup) are made in :meth:`reset` and :meth:`step`; :meth:`reset_from`
    and :meth:`step_from` take them as given."""

    max_episode_steps = 200
    n_headings = 36

    def __init__(self) -> None:
        self.observation_space = Box(low=0, high=255, shape=RES, dtype=torch.uint8)
        self.action_space = Discrete(len(normal_button_comb()))

    def _signed(self, rel: torch.Tensor) -> torch.Tensor:
        """A bearing in [0, 36) as one in (-18, 18]."""
        return torch.where(rel > self.n_headings // 2, rel - self.n_headings, rel)

    def _obs(self, s: _DoomState) -> torch.Tensor:
        """``[E, 40, 60, 1]`` uint8 frames of the states ``s``."""
        H, W, _ = RES
        signed = self._signed((s.target - s.heading) % self.n_headings)  # floor-mod: a bearing in [0, 36)
        # visible in a 180 degree field of view: bearings [-9, +9] map onto the columns [0, W)
        col_center = (W // 2 + signed * (W // (self.n_headings // 2))).to(torch.int32)[:, None, None]
        # the medikit looks wider and taller as it gets closer
        half_w = (3 + (30 - s.dist) // 4).to(torch.int32)[:, None, None]
        top = (H * s.dist / 60).to(torch.int32)[:, None, None]  # true division, then truncation
        visible = (signed.abs() <= self.n_headings // 4)[:, None, None]
        cols = torch.arange(W, dtype=torch.int32, device=s.heading.device)[None, None, :]
        rows = torch.arange(H, dtype=torch.int32, device=s.heading.device)[None, :, None]
        img = ((cols - col_center).abs() <= half_w) & (rows >= top) & visible
        # a floor texture gives the net a horizon to read
        floor = (rows >= 3 * H // 4) & ((cols + rows) % 7 == 0)
        return ((img | floor).to(torch.uint8) * 255)[..., None]

    def reset_from(self, heading: torch.Tensor, target: torch.Tensor) -> tuple[_DoomState, torch.Tensor]:
        heading = heading.to(torch.int32)
        s = _DoomState(heading, target.to(torch.int32), torch.full_like(heading, 25), torch.zeros_like(heading))
        return s, self._obs(s)

    def reset(self, num_envs, generator, device):
        heading, target = torch.randint(0, self.n_headings, (2, num_envs), generator=generator, device=device,
                                        dtype=torch.int32)
        return self.reset_from(heading, target)

    def step_from(self, state: _DoomState, action: torch.Tensor, new_target: torch.Tensor) -> EnvStep:
        # the normal_button_comb order: [stay, forward] x [no turn, right, left]
        fwd = action >= 3
        turn = torch.where(action % 3 == 1, 1, torch.where(action % 3 == 2, -1, 0))
        heading = ((state.heading + turn) % self.n_headings).to(torch.int32)
        facing = self._signed((state.target - heading) % self.n_headings).abs() <= 2
        dist = torch.where(fwd & facing, state.dist - 1, state.dist)
        collected = dist <= 0
        rew = torch.where(collected, 1.0, 0.0).to(torch.float32)
        s = _DoomState(heading, torch.where(collected, new_target.to(torch.int32), state.target),
                       torch.where(collected, 25, dist).to(torch.int32), state.t + 1)
        return EnvStep(
            state=s, obs=self._obs(s), reward=rew,
            terminated=torch.zeros_like(collected),  # fixed horizon: truncation only
            truncated=s.t >= self.max_episode_steps,
            info=Batch(),
        )

    def step(self, state, action, generator):
        new_target = torch.randint(0, self.n_headings, state.target.shape, generator=generator,
                                   device=state.target.device, dtype=torch.int32)
        return self.step_from(state, action, new_target)


def make_vizdoom_env(task: str = "D1_basic", frame_skip: int = 4, res=(STACK, *RES[:2]),
                     num_training_envs: int = 10, num_test_envs: int = 10, seed=None, device=None):
    """(env, train envs, test envs): ``SubprocVectorEnv`` stacks of the real
    ``DoomGame`` when ``vizdoom`` is installed (the scenario's ``maps/<task>.cfg``
    beside this file), ``FrameStack(SyntheticDoom(), 4)`` device envs on
    ``device`` otherwise (reference env.py:136). ``seed`` is taken for the
    reference's signature and unused, as in the JAX package."""
    try:
        import vizdoom  # noqa: F401
    except ImportError:
        env = FrameStack(SyntheticDoom(), STACK)
        dev = resolve_device(device)
        return env, VectorDeviceEnv(env, num_training_envs, device=dev), VectorDeviceEnv(env, num_test_envs, device=dev)
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv

    cfg = str(Path(__file__).parent / "maps" / f"{task}.cfg")

    def make():
        return VizdoomEnv(cfg, frameskip=frame_skip, res=res)

    return (make(), SubprocVectorEnv([make for _ in range(num_training_envs)]),
            SubprocVectorEnv([make for _ in range(num_test_envs)]))


def make_collectors(train_envs, test_envs, algo, buffer, device):
    """(train collector, test collector): ``DeviceCollector``s over the synthetic device envs, or
    ``HostCollector``s over the real game's subprocess envs, which a device collector cannot step (the JAX
    scripts hand those to their device collector). ``buffer`` is the train collector's (None: on-policy)."""
    if isinstance(train_envs, VectorDeviceEnv):
        from tianshou_tpu_torch.data.collector import DeviceCollector

        return DeviceCollector(train_envs, algo, buffer), DeviceCollector(test_envs, algo, None)
    from tianshou_tpu_torch.data.host_collector import HostCollector

    return HostCollector(train_envs, algo, buffer, device=device), HostCollector(test_envs, algo, None, device=device)
