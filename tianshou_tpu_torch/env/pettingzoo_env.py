"""PettingZoo AEC adapter (port of ``tianshou_tpu/env/pettingzoo_env.py``;
reference env/pettingzoo_env.py:20).

Converts a PettingZoo turn-based env into the multi-agent dict-obs contract
used by the host collector and the MARL dispatcher:
``obs = {agent_id, obs, mask}``, per-agent reward vectors (:117). Gated on
the optional ``pettingzoo`` package, imported when an adapter is made; the built-in
:class:`tianshou_tpu_torch.env.tictactoe.TicTacToeEnv` provides the same contract
without the dependency.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PettingZooEnv"]


class PettingZooEnv:
    def __init__(self, env) -> None:
        try:
            from pettingzoo.utils.env import AECEnv
        except ImportError as e:  # pragma: no cover
            raise ImportError("pettingzoo is not installed") from e
        assert isinstance(env, AECEnv)
        self.env = env
        env.reset()
        self.agents = list(env.agents)
        self.agent_idx = {a: i for i, a in enumerate(self.agents)}
        self.action_space = env.action_space(self.agents[0])
        self.observation_space = env.observation_space(self.agents[0])

    def _wrap_obs(self, observation) -> dict:
        agent = self.env.agent_selection
        if isinstance(observation, dict) and "action_mask" in observation:
            obs, mask = observation["observation"], np.asarray(observation["action_mask"], bool)
        else:
            obs = observation
            mask = np.ones(self.action_space.n, bool)
        return {"agent_id": np.int32(self.agent_idx[agent]), "obs": np.asarray(obs), "mask": mask}

    def reset(self, seed: int | None = None, **kwargs):
        self.env.reset(seed=seed)
        observation, _, _, _, info = self.env.last()
        return self._wrap_obs(observation), info

    def step(self, action):
        self.env.step(int(action))
        observation, _, term, trunc, info = self.env.last()
        rew = np.array([self.env.rewards.get(a, 0.0) for a in self.agents], np.float32)
        done = all(self.env.terminations.values()) or all(self.env.truncations.values())
        return self._wrap_obs(observation), rew, bool(done or term), bool(trunc), info

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()
