"""The multi-agent dispatcher (``tianshou_tpu_torch.algorithm.multiagent.marl``)
against the JAX package's.

Both sides get the same numpy transitions of a tic-tac-toe-shaped game
(``{agent_id, obs [3, 3, 2], mask [9]}`` observations, ``[2]`` rewards),
the same weights (flax's, carried over by
``models/convert.py:marl_params_from_flax`` and ``train_state_from_flax``)
and the same sampled rows (JAX's draw from the update's key, handed over as
``Draws(indices=)``).

- One ``MultiAgentOffPolicyAlgorithm.update`` with two DQN agents over
  ``MaskedQNet`` (n-step 3 and 1) over prioritized replay: each
  agent's loss and TD errors at rtol 1e-4 / atol 1e-5 and its weights after
  one Adam step at atol 2e-5 with 99.9% within 2e-6 (the tolerance of
  ``tests/test_torch_dqn.py``); with PER the shared sum tree at rtol 1e-6
  (``tests/test_torch_prio.py``) and the max / min priority (a TD error's
  ``|.| + eps``) at the TD errors' tolerance, written through the per-agent
  reward views.
- The hand-computed n-step target of ``tests/test_marl.py:163`` in both
  packages, through the agent's own ``preprocess`` on the reward view.
- One ``MultiAgentOnPolicyAlgorithm.update_rollout`` with two PPO agents over
  a masked actor and a critic defined here in both frameworks, with JAX's
  minibatch permutations per agent handed over: weights within 1e-4 and
  99.9% within 2e-6, stats at atol 1e-4 (``tests/test_torch_onpolicy.py``).
- ``MARLRandomPolicy`` never picks a masked action, and the dispatcher's
  acting selects each row's agent.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.multiagent import marl as jmarl
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.env.core import Discrete as JDiscrete
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu.models.mlp import MLP as JMLP
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.multiagent import marl
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.models import discrete as tdisc
from tianshou_tpu_torch.models.convert import marl_params_from_flax, mlp_params_from_flax, train_state_from_flax
from tianshou_tpu_torch.models.mlp import MLP
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, STEPS, B, H = 2, 24, 16, 32
TOL = dict(rtol=1e-4, atol=1e-5)


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def obs_example(jax_side: bool):
    d = dict(agent_id=np.int32(0), obs=np.zeros((3, 3, 2), np.float32), mask=np.ones(9, bool))
    return JBatch(**{k: jnp.asarray(v) for k, v in d.items()}) if jax_side else Batch(
        **{k: torch.as_tensor(v) for k, v in d.items()})


def transition_example(jax_side: bool):
    ob = obs_example(jax_side)
    if jax_side:
        return JBatch(obs=ob, act=jnp.int32(0), rew=jnp.zeros(2, jnp.float32), terminated=jnp.bool_(False),
                      truncated=jnp.bool_(False), obs_next=ob)
    return Batch(obs=ob, act=torch.tensor(0), rew=torch.zeros(2), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=ob)


def random_obs(rng, shape):
    mask = rng.random(shape + (9,)) < 0.6
    mask[..., 0] = True
    return dict(agent_id=rng.integers(0, 2, shape).astype(np.int32),
                obs=rng.integers(0, 2, shape + (3, 3, 2)).astype(np.float32), mask=mask)


def steps(seed: int):
    """``STEPS`` vector steps of ``E`` envs as numpy dicts (episodes end at random)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ob = random_obs(rng, (E,))
        term = rng.random(E) < 0.15
        out.append(dict(obs=ob, act=rng.integers(0, 9, E).astype(np.int32), rew=rng.normal(size=(E, 2)).astype(np.float32),
                        terminated=term, truncated=(rng.random(E) < 0.05) & ~term, obs_next=random_obs(rng, (E,))))
    return out


def as_jax(d):
    return JBatch(**{k: as_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in d.items()})


def as_torch(d):
    return Batch(**{k: as_torch(v) if isinstance(v, dict) else torch.as_tensor(v) for k, v in d.items()})


def filled(seed: int = 0):
    """Both packages' prioritized rings holding ``steps(seed)``."""
    jbuf, tbuf = JPVRB(64, E, alpha=0.6, beta=0.4), PrioritizedVectorReplayBuffer(64, E, alpha=0.6, beta=0.4)
    js, ts = jbuf.init(transition_example(True)), tbuf.init(transition_example(False), device="cpu")
    jadd = jax.jit(jbuf.add)
    for st in steps(seed):
        js, _ = jadd(js, as_jax(st))
        ts, _ = tbuf.add(ts, as_torch(st))
    return jbuf, js, tbuf, ts


def dqn_pair(n_step: int):
    kw = dict(gamma=0.9, n_step_return_horizon=n_step, target_update_freq=2, eps_training=0.2)
    j = JDQN(model=jdisc.MaskedQNet((H,), 9), action_space=JDiscrete(9), optim=JAdam(lr=1e-3), **kw)
    t = DQN(model=tdisc.MaskedQNet((H,), 9, input_dim=18), action_space=Discrete(9),
            optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return j, t


def marl_pair(n_steps=(3, 1)):
    pairs = [dqn_pair(n) for n in n_steps]
    jm = jmarl.MultiAgentOffPolicyAlgorithm([p[0] for p in pairs], action_space=JDiscrete(9))
    tm = marl.MultiAgentOffPolicyAlgorithm([p[1] for p in pairs], action_space=Discrete(9))
    jts = jm.init(jax.random.key(0), obs_example(True))
    tts = train_state_from_flax(jts, tm.init("cpu"))
    return jm, jts, tm, tts


def assert_weights_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.detach().numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(g - w) <= 2e-6) >= 0.999, k


def test_marl_params_from_flax_maps_each_agent():
    jm, jts, tm, tts = marl_pair()
    params = {k: npy(v.params) for k, v in jts.items()}
    sds = marl_params_from_flax(params, tm.algorithms)
    assert set(sds) == {"agent0", "agent1"}
    for k, sd in sds.items():
        assert set(sd) == set(tts[k].model.state_dict())
        for name, v in sd.items():
            assert torch.equal(v, tts[k].model.state_dict()[name]), (k, name)
            assert torch.equal(v, tts[k].target.state_dict()[name]), (k, name)
    assert marl_params_from_flax({"agent0": {}}, [marl.MARLRandomPolicy(Discrete(9))]) == {"agent0": {}}


def test_one_marl_update_matches_jax():
    """Over prioritized replay, the PER weight times ``is_mine`` (the uniform ring's ``is_mine`` alone runs in the
    builder runs of ``tests/test_torch_highlevel_runs.py``)."""
    jbuf, js, tbuf, bs = filled()
    jm, jts, tm, tts = marl_pair()
    key = jax.random.key(7)
    k_sample, _ = jax.random.split(key)
    idx = np.asarray(jbuf.sample(js, k_sample, B)[1])
    jts2, js2, jstats = jax.jit(lambda t, s, k: jm.update(t, jbuf, s, k, B))(jts, js, key)
    out_ts, out_bs, stats = tm.update(tts, tbuf, bs, Draws(indices=torch.tensor(idx, dtype=torch.int64)), B)
    assert out_ts is tts and out_bs is bs  # written in place
    want = marl_params_from_flax({a: npy(v.params) for a, v in jts2.items()}, tm.algorithms)
    for a in ("agent0", "agent1"):
        np.testing.assert_allclose(stats[a].loss.item(), float(jstats[a].loss), **TOL)
        np.testing.assert_allclose(stats[a].td_error.numpy(), np.asarray(jstats[a].td_error), **TOL)
        assert_weights_close(tts[a].model.state_dict(), want[a])
        assert int(tts[a].step) == int(jts2[a].step) == 1
    np.testing.assert_allclose(bs.tree.numpy(), np.asarray(js2.tree), rtol=1e-6, atol=0)
    for k in ("max_prio", "min_prio"):  # a TD error's |.| + eps: the TD errors' tolerance
        np.testing.assert_allclose(float(getattr(bs, k)), float(getattr(js2, k)), **TOL, err_msg=k)
    assert not np.array_equal(np.asarray(js2.tree), np.asarray(js.tree))  # both agents wrote priorities


def test_nstep_target_through_the_reward_view_is_hand_computed():
    """``tests/test_marl.py:163`` in both packages: a 3-step episode ending in
    the chain gives the agent's pure discounted reward sum."""
    gamma = 0.9
    rews = [(1.0, -1.0), (2.0, -2.0), (4.0, -4.0)]
    expected = 1.0 + gamma * 2.0 + gamma**2 * 4.0
    got = []
    for jax_side in (True, False):
        (jd, td), other = dqn_pair(3), dqn_pair(1)
        for algo in (jd, td):
            algo.gamma = gamma
        if jax_side:
            m = jmarl.MultiAgentOffPolicyAlgorithm([jd, other[0]], action_space=JDiscrete(9))
            ts = m.init(jax.random.key(0), obs_example(True))
            buf = JVRB(16, 1)
            state = buf.init(transition_example(True))
        else:
            m = marl.MultiAgentOffPolicyAlgorithm([td, other[1]], action_space=Discrete(9))
            ts = m.init("cpu")
            buf = VectorReplayBuffer(16, 1)
            state = buf.init(transition_example(False), device="cpu")
        conv = as_jax if jax_side else as_torch
        for t, (r0, r1) in enumerate(rews):
            ob = dict(agent_id=np.zeros(1, np.int32), obs=np.zeros((1, 3, 3, 2), np.float32), mask=np.ones((1, 9), bool))
            tr = dict(obs=ob, act=np.array([t], np.int32), rew=np.array([[r0, r1]], np.float32),
                      terminated=np.array([t == 2]), truncated=np.array([False]), obs_next=ob)
            state, _ = buf.add(state, conv(tr))
        if jax_side:
            idx = jnp.zeros(1, jnp.int32)
            b = buf.get(state, idx)
            b.rew = b.rew[:, 0]
            out = jd.preprocess(ts["agent0"], buf, m._agent_reward_view(state, 0), b, idx, jax.random.key(2))
        else:
            idx = torch.zeros(1, dtype=torch.int64)
            b = buf.get(state, idx)
            b.rew = b.rew[:, 0]
            view = m._agent_reward_view(state, 0)
            assert view.data.rew.data_ptr() == state.data.rew.data_ptr()  # a strided view of the shared ring
            out = td.preprocess(ts["agent0"], buf, view, b, idx, torch.Generator())
        got.append(np.asarray(out.returns))
    np.testing.assert_allclose(got[0], [expected], rtol=1e-5)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# on-policy: PPO agents over a masked actor and a critic, in both frameworks
# ---------------------------------------------------------------------------
class JMaskedActor(fnn.Module):
    @fnn.compact
    def __call__(self, obs):
        logits = JMLP((H,), 9)(obs.obs.reshape(obs.obs.shape[0], -1))
        return jnp.where(obs.mask, logits, -1e9)


class JBoardCritic(fnn.Module):
    @fnn.compact
    def __call__(self, obs):
        return JMLP((H,), 1)(obs.obs.reshape(obs.obs.shape[0], -1))


class MaskedActor(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(18, (H,), 9)

    def forward(self, obs):
        return torch.where(obs.mask, self.mlp(obs.obs.reshape(obs.obs.shape[0], -1)), -1e9)


class BoardCritic(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(18, (H,), 1)

    def forward(self, obs):
        return self.mlp(obs.obs.reshape(obs.obs.shape[0], -1))


def ac_state_dict(params) -> dict:
    return {f"{k}.{n}": v for k in ("actor", "critic")
            for n, v in mlp_params_from_flax(npy(params[k])["params"]["MLP_0"], "mlp.").items()}


T_ROLL, E_ROLL, REPEAT, MB = 8, 4, 2, 16


def test_one_marl_update_rollout_matches_jax():
    kw = dict(gamma=0.95, gae_lambda=0.95, ent_coef=0.01, deterministic_eval=True, action_scaling=False)
    jagents = [JPPO(actor=JMaskedActor(), critic=JBoardCritic(), action_space=JDiscrete(9),
                    optim=JAdam(lr=1e-3, max_grad_norm=0.5), **kw) for _ in range(2)]
    tagents = [PPO(actor=MaskedActor(), critic=BoardCritic(), action_space=Discrete(9),
                   optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5), **kw) for _ in range(2)]
    jm = jmarl.MultiAgentOnPolicyAlgorithm(jagents, action_space=JDiscrete(9))
    tm = marl.MultiAgentOnPolicyAlgorithm(tagents, action_space=Discrete(9))
    jts = jm.init(jax.random.key(0), obs_example(True))
    tts = tm.init("cpu")
    for a in tts:
        tts[a].model.load_state_dict(ac_state_dict(jts[a].params))
    rng = np.random.default_rng(3)
    term = rng.random((T_ROLL, E_ROLL)) < 0.2
    roll = dict(obs=random_obs(rng, (T_ROLL, E_ROLL)), act=rng.integers(0, 9, (T_ROLL, E_ROLL)).astype(np.int32),
                rew=rng.normal(size=(T_ROLL, E_ROLL, 2)).astype(np.float32), terminated=term,
                truncated=(rng.random((T_ROLL, E_ROLL)) < 0.1) & ~term, obs_next=random_obs(rng, (T_ROLL, E_ROLL)))
    roll["obs"]["mask"][np.arange(T_ROLL)[:, None], np.arange(E_ROLL), roll["act"]] = True  # the taken action is valid
    key = jax.random.key(5)
    jts2, jstats = jm.update_rollout(jts, as_jax(roll), key, repeat=REPEAT, batch_size=MB)
    n = T_ROLL * E_ROLL
    perms = []
    for k in jax.random.split(key, 2):  # per agent: k_proc, k_loop = split(key_i); a pass's k_perm from k_loop
        _, k_loop = jax.random.split(k)
        perms.append(torch.from_numpy(np.stack([np.asarray(jax.random.permutation(jax.random.split(rk)[0], n))
                                                .reshape(n // MB, MB) for rk in jax.random.split(k_loop, REPEAT)])))
    _, stats = tm.update_rollout(tts, as_torch(roll), None, REPEAT, MB, perm=perms)
    assert tm.rollout_grad_steps(n, REPEAT, MB) == int(stats.n_grad_steps) == int(jstats.n_grad_steps) == 2 * REPEAT * 2
    for a in ("agent0", "agent1"):
        assert_weights_close(tts[a].model.state_dict(), ac_state_dict(jts2[a].params))
        assert int(tts[a].step) == int(jts2[a].step) == REPEAT * 2
        for k in stats[a].keys():
            if k != "n_grad_steps":
                np.testing.assert_allclose(float(stats[a][k]), float(jstats[a][k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_random_policy_never_picks_a_masked_action_and_dispatch_selects_by_agent():
    rng = np.random.default_rng(0)
    ob = random_obs(rng, (4096,))
    obs = as_torch(ob)
    rp = marl.MARLRandomPolicy(Discrete(9))
    g = torch.Generator().manual_seed(0)
    act = rp.forward(rp.init("cpu"), obs, g).act
    assert bool(obs.mask[torch.arange(4096), act].all())
    counts = torch.bincount(act[obs.mask.all(-1)], minlength=9)
    assert int(counts.min()) > 0  # every action drawn where all are valid
    assert int(rp._target_q(None, obs).abs().sum()) == 0 and rp.update_step(None, Batch())[1] == Batch()
    # agent 0 always plays action 0 (its only valid one under a one-hot mask), agent 1 samples
    fixed = dqn_pair(1)[1]
    m = marl.MultiAgentOffPolicyAlgorithm([fixed, rp], action_space=Discrete(9))
    ts = m.init("cpu")
    ob["mask"][ob["agent_id"] == 0] = np.eye(9, dtype=bool)[0]
    obs = as_torch(ob)
    act = m.forward(ts, obs, g).act
    assert bool((act[obs.agent_id == 0] == 0).all())
    assert bool(obs.mask[torch.arange(4096), act].all())
    assert len(torch.unique(act[obs.agent_id == 1])) == 9
    noisy = m.exploration_noise(ts, act, obs, g, training=True)
    assert bool(obs.mask[torch.arange(4096), noisy].all())


# ---------------------------------------------------------------------------
# slow: self-play to the win-rate bars of tests/test_marl.py
# ---------------------------------------------------------------------------
def _win_rate(tm, tts, g, n_episode: int = 60) -> float:
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv

    rp = marl.MARLRandomPolicy(Discrete(9))
    ev = marl.MultiAgentOffPolicyAlgorithm([tm.algorithms[0], rp], action_space=Discrete(9))
    ec = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(8)]), ev, None, device="cpu")
    ec.reset(seed=123)
    stats = ec.collect({"agent0": tts["agent0"], "agent1": rp.init("cpu")}, g, n_episode=n_episode, training=False)
    return float((stats.returns > 0).mean())


def _board_dqn():
    return DQN(model=tdisc.MaskedQNet((128, 128), 9, input_dim=18), action_space=Discrete(9),
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9, n_step_return_horizon=1, target_update_freq=200,
               eps_training=0.2)


@pytest.mark.slow
def test_marl_selfplay_beats_random():
    """``tests/test_marl.py:54``: DQN self-play, 150 rounds of 64 steps and one update of 64; agent 0 wins at
    least 0.7 of 60 games against the mask-aware random policy."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv

    torch.manual_seed(0)
    tm = marl.MultiAgentOffPolicyAlgorithm([_board_dqn(), _board_dqn()], action_space=Discrete(9))
    tts = tm.init("cpu")
    buf = VectorReplayBuffer(20000, 8)
    coll = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(8)]), tm, buf, device="cpu")
    coll.reset(seed=0)
    coll.reset_buffer(transition_example(False))
    g = torch.Generator().manual_seed(0)
    coll.collect(tts, g, n_step=500)
    for _ in range(150):
        coll.collect(tts, g, n_step=64)
        tm.update(tts, buf, coll.buf_state, g, 64)
    assert _win_rate(tm, tts, g) >= 0.7


@pytest.mark.slow
def test_marl_onpolicy_selfplay_beats_random():
    """``tests/test_marl.py:108``: PPO self-play through ``MultiAgentOnPolicyAlgorithm``, 60 rollouts of 64 steps,
    4 passes of batch 128; agent 0 wins at least 0.6 of 60 games against the random policy."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv

    class Actor(MaskedActor):
        def __init__(self):
            super().__init__()
            self.mlp = MLP(18, (128, 128), 9)

    class Critic(BoardCritic):
        def __init__(self):
            super().__init__()
            self.mlp = MLP(18, (128, 128), 1)

    torch.manual_seed(0)
    agents = [PPO(actor=Actor(), critic=Critic(), action_space=Discrete(9),
                  optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), gamma=0.95, gae_lambda=0.95, ent_coef=0.01,
                  deterministic_eval=True, action_scaling=False) for _ in range(2)]
    tm = marl.MultiAgentOnPolicyAlgorithm(agents, action_space=Discrete(9))
    tts = tm.init("cpu")
    coll = HostCollector(DummyVectorEnv([TicTacToeEnv for _ in range(8)]), tm, None, device="cpu")
    coll.reset(seed=0)
    g = torch.Generator().manual_seed(0)
    for _ in range(60):
        rollout, _ = coll.collect_rollout(tts, g, 64)
        tm.update_rollout(tts, rollout, g, 4, 128)
    assert _win_rate(tm, tts, g) >= 0.6
