"""TicTacToe (port of ``tianshou_tpu/env/tictactoe.py``): the built-in
turn-based two-player board env of the host path, numpy only.

Plays the role of the reference's PettingZoo tic-tac-toe fixture
(test/pettingzoo/tic_tac_toe.py): observations follow the reference's
multi-agent convention (``{agent_id, obs, mask}``, pettingzoo_env.py:75-93)
and rewards are per-agent vectors (:117). Use with
:class:`tianshou_tpu_torch.env.venvs.DummyVectorEnv` + the host collector.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TicTacToeEnv"]

_WIN_LINES = [
    (0, 1, 2), (3, 4, 5), (6, 7, 8),
    (0, 3, 6), (1, 4, 7), (2, 5, 8),
    (0, 4, 8), (2, 4, 6),
]


class TicTacToeEnv:
    """Gymnasium-like API; obs is a dict {agent_id, obs, mask}."""

    num_agents = 2

    def __init__(self) -> None:
        self.board = np.zeros(9, np.int8)  # 0 empty, 1 player0, 2 player1
        self.current = 0
        self._rng = np.random.default_rng()

    # -- spaces (minimal shims for the host stack)
    @property
    def observation_space(self):
        class S:
            shape = (3, 3, 2)

        return S()

    @property
    def action_space(self):
        class A:
            n = 9

            def sample(self_inner):
                legal = np.where(self.board == 0)[0]
                return int(self._rng.choice(legal)) if len(legal) else 0

        return A()

    def _obs(self) -> dict:
        own = (self.board == self.current + 1).astype(np.float32).reshape(3, 3)
        opp = (self.board == 2 - self.current).astype(np.float32).reshape(3, 3)
        return {
            "agent_id": np.int32(self.current),
            "obs": np.stack([own, opp], axis=-1),
            "mask": (self.board == 0),
        }

    def reset(self, seed: int | None = None, **kwargs):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.board[:] = 0
        self.current = 0
        return self._obs(), {}

    def step(self, action: int):
        action = int(action)
        rew = np.zeros(2, np.float32)
        if self.board[action] != 0:  # illegal (shouldn't happen with masking)
            rew[self.current] = -1.0
            rew[1 - self.current] = 1.0
            return self._obs(), rew, True, False, {}
        self.board[action] = self.current + 1
        mark = self.current + 1
        won = any(all(self.board[i] == mark for i in line) for line in _WIN_LINES)
        draw = (self.board != 0).all()
        if won:
            rew[self.current] = 1.0
            rew[1 - self.current] = -1.0
        self.current = 1 - self.current
        return self._obs(), rew, bool(won or draw), False, {}

    def render(self):
        sym = {0: ".", 1: "x", 2: "o"}
        rows = ["".join(sym[v] for v in self.board[i : i + 3]) for i in (0, 3, 6)]
        return "\n".join(rows)

    def close(self):
        pass
