"""The board envs of the multi-agent path in the port
(``tianshou_tpu_torch.env.tictactoe``, ``tianshou_tpu_torch.env.pettingzoo_env``)
against the JAX package's.

- TicTacToe: seeded games (each env's own ``action_space.sample``, reseeded
  by ``reset(seed=)``) give the same moves, observations (``agent_id``, the
  two ``[3, 3]`` planes, the mask), reward vectors, termination flags and
  renderings in both packages, bit for bit; the win and illegal-move rules of
  ``tests/test_marl.py:48``.
- The PettingZoo adapter's contract (``tests/test_pettingzoo_adapter.py``):
  both adapters over an AEC tic-tac-toe written here against
  ``pettingzoo.utils.env.AECEnv`` give the same outputs bit for bit, move by
  move, through reset, masking, the agent rotation, the reward vector and
  the termination.
- A host collect with dict observations: the port's ``HostCollector`` and the
  JAX one over ``DummyVectorEnv`` s of TicTacToe, with two greedy masked DQN
  agents holding the same weights, write the same rings (observations,
  masks, agent ids, actions, reward vectors, flags) and return the same
  episodes.
- ``slow``: the twin of ``tests/test_pettingzoo.py::test_pettingzoo_marl_collect_and_update``
  on the real ``pettingzoo.classic`` tic-tac-toe (not tier-1: another test
  module may install a stub ``pettingzoo`` in the same process).
"""

import jax
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.multiagent import marl as jmarl
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.host_collector import HostCollector as JHostCollector
from tianshou_tpu.env import pettingzoo_env as jpz
from tianshou_tpu.env import tictactoe as jttt
from tianshou_tpu.env.core import Discrete as JDiscrete
from tianshou_tpu.env.venvs import DummyVectorEnv as JDummy
from tianshou_tpu_torch.algorithm.multiagent import marl
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.host_collector import HostCollector
from tianshou_tpu_torch.env import pettingzoo_env as tpz
from tianshou_tpu_torch.env import tictactoe as tttt
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.env.venvs import DummyVectorEnv
from tests.test_torch_marl import dqn_pair, obs_example, transition_example
from tianshou_tpu_torch.models.convert import train_state_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def assert_obs_equal(a: dict, b: dict):
    assert set(a) == set(b) == {"agent_id", "obs", "mask"}
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tictactoe_games_are_bit_exact(seed):
    jenv, tenv = jttt.TicTacToeEnv(), tttt.TicTacToeEnv()
    assert tenv.observation_space.shape == jenv.observation_space.shape == (3, 3, 2)
    assert tenv.action_space.n == jenv.action_space.n == 9 and tenv.num_agents == jenv.num_agents == 2
    for game in range(3):
        jo, _ = jenv.reset(seed=seed * 10 + game)
        to, _ = tenv.reset(seed=seed * 10 + game)
        assert_obs_equal(to, jo)
        done = False
        while not done:
            ja, ta = jenv.action_space.sample(), tenv.action_space.sample()
            assert ta == ja and to["mask"][ta]
            jo, jr, jterm, jtrunc, _ = jenv.step(ja)
            to, tr, tterm, ttrunc, _ = tenv.step(ta)
            assert_obs_equal(to, jo)
            assert tr.dtype == jr.dtype == np.float32
            np.testing.assert_array_equal(tr, jr)
            assert (tterm, ttrunc) == (jterm, jtrunc)
            assert tenv.render() == jenv.render()
            done = tterm or ttrunc
        assert tr.sum() == 0.0 and abs(tr[0]) in (0.0, 1.0)


def test_tictactoe_win_and_illegal_move_rules():
    for env in (tttt.TicTacToeEnv(), jttt.TicTacToeEnv()):
        obs, _ = env.reset(seed=0)
        assert obs["agent_id"] == 0 and obs["mask"].all()
        for a in (0, 3, 1, 4, 2):  # x takes the top row
            obs, rew, term, trunc, _ = env.step(a)
        assert term and not trunc and list(rew) == [1.0, -1.0]
        env.reset()
        env.step(4)
        obs, rew, term, _, _ = env.step(4)  # o plays an occupied square: o loses
        assert term and list(rew) == [1.0, -1.0] and obs["agent_id"] == 1


# ---------------------------------------------------------------------------
# the PettingZoo adapter over an AEC tic-tac-toe written against the AEC base class
# ---------------------------------------------------------------------------
_WIN_LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7), (2, 5, 8), (0, 4, 8), (2, 4, 6)]


def make_aec():
    from pettingzoo.utils.env import AECEnv

    class _Discrete9:
        n = 9

    class _BoardSpace:
        shape = (3, 3, 2)

    class AecTicTacToe(AECEnv):
        """Tic-tac-toe speaking the AEC protocol (``last`` defined here, so
        that the real base class and a stand-in serve alike)."""

        metadata = {"name": "aec_tictactoe"}

        def __init__(self) -> None:
            self.possible_agents = ["player_1", "player_2"]
            self.agents = list(self.possible_agents)
            self.reset()

        def observation_space(self, agent):
            return _BoardSpace()

        def action_space(self, agent):
            return _Discrete9()

        def observe(self, agent):
            i = self.possible_agents.index(agent)
            own = (self.board == i + 1).astype(np.float32).reshape(3, 3)
            opp = (self.board == 2 - i).astype(np.float32).reshape(3, 3)
            return {"observation": np.stack([own, opp], axis=-1), "action_mask": (self.board == 0).astype(np.int8)}

        def last(self):
            a = self.agent_selection
            return (self.observe(a), self._cumulative_rewards[a], self.terminations[a], self.truncations[a],
                    self.infos[a])

        def reset(self, seed=None, options=None):
            self.board = np.zeros(9, np.int8)
            self.agents = list(self.possible_agents)
            self.agent_selection = self.agents[0]
            self.rewards = {a: 0.0 for a in self.agents}
            self._cumulative_rewards = {a: 0.0 for a in self.agents}
            self.terminations = {a: False for a in self.agents}
            self.truncations = {a: False for a in self.agents}
            self.infos = {a: {} for a in self.agents}

        def step(self, action):
            agent = self.agent_selection
            i = self.possible_agents.index(agent)
            other = self.possible_agents[1 - i]
            self.rewards = {a: 0.0 for a in self.possible_agents}
            self.board[action] = i + 1
            won = any(all(self.board[j] == i + 1 for j in line) for line in _WIN_LINES)
            if won:
                self.rewards[agent], self.rewards[other] = 1.0, -1.0
            if won or bool((self.board != 0).all()):
                self.terminations = {a: True for a in self.possible_agents}
            self._cumulative_rewards = dict(self.rewards)
            self.agent_selection = other

        def render(self):
            return str(self.board.reshape(3, 3))

        def close(self):
            pass

    return AecTicTacToe()


def test_pettingzoo_adapter_contract_matches_jax():
    jenv, tenv = jpz.PettingZooEnv(make_aec()), tpz.PettingZooEnv(make_aec())
    assert tenv.agents == jenv.agents == ["player_1", "player_2"] and tenv.action_space.n == 9
    rng = np.random.default_rng(0)
    for game in range(6):
        jo, _ = jenv.reset(seed=game)
        to, _ = tenv.reset(seed=game)
        assert_obs_equal(to, jo)
        assert to["agent_id"] == 0 and to["mask"].all() and to["mask"].dtype == bool
        done, n = False, 0
        while not done:
            a = int(rng.choice(np.flatnonzero(to["mask"])))
            jo, jr, jterm, jtrunc, _ = jenv.step(a)
            to, tr, tterm, ttrunc, _ = tenv.step(a)
            n += 1
            assert_obs_equal(to, jo)
            assert to["agent_id"] == n % 2 and not to["mask"][a]
            np.testing.assert_array_equal(tr, jr)
            assert tr.shape == (2,) and (tterm, ttrunc) == (jterm, jtrunc)
            done = tterm or ttrunc
        assert tr.sum() == 0.0
    assert tenv.render() == jenv.render()


def test_host_collect_with_dict_observations_matches_jax():
    E, N_STEP = 4, 40
    (jd0, td0), (jd1, td1) = dqn_pair(1), dqn_pair(1)
    for algo in (jd0, td0, jd1, td1):
        algo.eps_training = 0.0  # greedy: both packages act alike
    jm = jmarl.MultiAgentOffPolicyAlgorithm([jd0, jd1], action_space=JDiscrete(9))
    tm = marl.MultiAgentOffPolicyAlgorithm([td0, td1], action_space=Discrete(9))
    jts = jm.init(jax.random.key(0), obs_example(True))
    tts = train_state_from_flax(jts, tm.init("cpu"))
    jbuf, tbuf = JVRB(256, E), VectorReplayBuffer(256, E)
    jcol = JHostCollector(JDummy([jttt.TicTacToeEnv for _ in range(E)]), jm, jbuf)
    tcol = HostCollector(DummyVectorEnv([tttt.TicTacToeEnv for _ in range(E)]), tm, tbuf, device="cpu")
    jcol.reset(seed=0)
    tcol.reset(seed=0)
    jcol.buf_state = jbuf.init(transition_example(True))
    tcol.reset_buffer(transition_example(False))
    jstats = jcol.collect(jts, jax.random.key(1), n_step=N_STEP)
    tstats = tcol.collect(tts, torch.Generator().manual_seed(1), n_step=N_STEP)
    assert (tstats.n_collected_steps, tstats.n_collected_episodes) == (jstats.n_collected_steps,
                                                                        jstats.n_collected_episodes)
    assert tstats.n_collected_episodes > 0
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    np.testing.assert_array_equal(tstats.lens, jstats.lens)
    jd, td = jcol.buf_state.data, tcol.buf_state.data
    assert td.rew.shape == (E, 64, 2)
    for k in ("act", "rew", "terminated", "truncated", "done"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    for k in ("agent_id", "obs", "mask"):
        np.testing.assert_array_equal(td.obs[k].numpy(), np.asarray(jd.obs[k]), err_msg=k)
        np.testing.assert_array_equal(td.obs_next[k].numpy(), np.asarray(jd.obs_next[k]), err_msg=k)
    np.testing.assert_array_equal(tcol.buf_state.cursor.numpy(), np.asarray(jcol.buf_state.cursor))


@pytest.mark.slow
def test_pettingzoo_marl_collect_and_update():
    """The port's twin of ``tests/test_pettingzoo.py``: the adapter over the real
    ``pettingzoo.classic`` tic-tac-toe, a MARL collect into the ring and five updates."""
    from pettingzoo.classic import tictactoe_v3

    envs = DummyVectorEnv([lambda: tpz.PettingZooEnv(tictactoe_v3.env()) for _ in range(4)])
    tm = marl.MultiAgentOffPolicyAlgorithm([dqn_pair(1)[1], dqn_pair(1)[1]], action_space=Discrete(9))
    ts = tm.init("cpu")
    buf = VectorReplayBuffer(4000, 4)
    coll = HostCollector(envs, tm, buf, device="cpu")
    coll.reset(seed=0)
    coll.reset_buffer(transition_example(False))
    g = torch.Generator().manual_seed(0)
    stats = coll.collect(ts, g, n_step=300)
    assert int(coll.buf_state.size.sum()) == 300 and stats.n_collected_episodes > 0
    assert set(np.unique(np.abs(stats.returns))) <= {0.0, 1.0}
    for _ in range(5):
        ts, coll.buf_state, st = tm.update(ts, buf, coll.buf_state, g, 64)
    for agent in ("agent0", "agent1"):
        assert np.isfinite(float(st[agent].loss))
    envs.close()
