"""High-level env factories (port of ``tianshou_tpu/highlevel/env.py``;
reference highlevel/env.py: ``EnvFactory:365``, ``EnvFactoryRegistered:486``,
``VectorEnvType:67``).

Two worlds:
- device factories are plain callables returning a batched :class:`Env`
  (one env steps every copy, so there is no venv-type choice to make);
- :class:`GymEnvFactory` covers registered Gymnasium tasks on the host path,
  with the reference's venv-type selection (dummy/subproc/shmem).
  ``gymnasium`` is imported only when an env is made.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from tianshou_tpu_torch.env.core import Box, Discrete

__all__ = ["VectorEnvType", "GymEnvFactory"]


class VectorEnvType(enum.Enum):
    DUMMY = "dummy"
    SUBPROC = "subproc"
    SHMEM = "shmem"

    def create_venv(self, env_fns):
        from tianshou_tpu_torch.env.shmem import ShmemVectorEnv
        from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv

        cls = {
            VectorEnvType.DUMMY: DummyVectorEnv,
            VectorEnvType.SUBPROC: SubprocVectorEnv,
            VectorEnvType.SHMEM: ShmemVectorEnv,
        }[self]
        return cls(env_fns)


@dataclasses.dataclass
class GymEnvFactory:
    """Factory over a registered Gymnasium task (reference
    EnvFactoryRegistered highlevel/env.py:486)."""

    task: str
    venv_type: VectorEnvType = VectorEnvType.DUMMY
    env_kwargs: dict = dataclasses.field(default_factory=dict)

    def _make(self):
        import gymnasium as gym

        return gym.make(self.task, **self.env_kwargs)

    def create_venv(self, num_envs: int, render_mode: str | None = None):
        if render_mode is not None:
            def make():
                import gymnasium as gym

                return gym.make(self.task, render_mode=render_mode, **self.env_kwargs)

            return VectorEnvType.DUMMY.create_venv([make for _ in range(num_envs)])
        return self.venv_type.create_venv([self._make for _ in range(num_envs)])

    def spaces(self) -> tuple:
        """(observation_space, action_space) as the port's Space descriptors."""
        env = self._make()
        obs_sp, act_sp = env.observation_space, env.action_space
        env.close()
        if hasattr(act_sp, "n"):
            act = Discrete(int(act_sp.n))
        else:
            act = Box(low=np.asarray(act_sp.low), high=np.asarray(act_sp.high))
        obs = Box(low=np.asarray(obs_sp.low, np.float32), high=np.asarray(obs_sp.high, np.float32))
        return obs, act
