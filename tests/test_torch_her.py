"""HER in the port (tianshou_tpu_torch/data/buffer/her.py, the HER branch of
``OffPolicyAlgorithm.preprocess`` and ``Algorithm.update``, and
env/classic/goal_reach.py) against the JAX package.

- GoalReach: resets from JAX's uniforms, steps and ``compute_reward`` exactly.
- The relabel plan and ``sample`` with JAX's draws handed over as ``Draws``
  (``indices``, ``her_offset``, ``her_relabel``, computed from the JAX key as
  its ``sample`` splits it): new goals, relabel masks, relabelled batches and
  ``n_step_gather_relabeled``'s chains exactly (index arithmetic, copies and
  the env's own reward rule), over episodes that end, wrap the ring and stay
  unfinished.
- The cases of ``tests/test_her.py`` (relabelled goals come from the episode,
  rewards follow the env's rule, the n-step chain's hand-computed rewards).
- One HER-DDPG update at n = 1 and n = 3 with the same weights and draws: the
  returns and losses at atol 1e-5, every weight after the update within 2e-5
  and 99.9% of each tensor within 2e-6 (``tests/test_torch_dqn.py``'s rule).
- HER-DDPG trained on GoalReach to -20 at n = 1 (beating the run without HER
  by 15) and at n = 3 (``slow``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tianshou_tpu.algorithm.modelfree.ddpg import DDPG as JDDPG
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.her import HERVectorReplayBuffer as JHERVRB
from tianshou_tpu.env.classic.goal_reach import GoalReach as JGoalReach
from tianshou_tpu.exploration.noise import GaussianNoise as JGaussianNoise
from tianshou_tpu.models.mlp import MLP as JMLP
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.her import HERReplayBuffer, HERVectorReplayBuffer
from tianshou_tpu_torch.env.classic.goal_reach import GoalReach
from tianshou_tpu_torch.exploration.noise import GaussianNoise
from tianshou_tpu_torch.models.convert import mlp_params_from_flax
from tianshou_tpu_torch.models.mlp import MLP
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, C, B = 3, 12, 16
TOL = dict(rtol=0, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def goal_tr(B_, xp, pos, goal, act, rew, term):
    pos, goal = np.asarray(pos, np.float32), np.asarray(goal, np.float32)
    obs = B_(observation=xp.asarray(pos), achieved_goal=xp.asarray(pos), desired_goal=xp.asarray(goal))
    nxt = B_(observation=xp.asarray(pos + np.float32(0.1)), achieved_goal=xp.asarray(pos + np.float32(0.1)),
             desired_goal=xp.asarray(goal))
    return B_(obs=obs, act=xp.asarray(np.asarray(act, np.float32)), rew=xp.asarray(np.asarray(rew, np.float32)),
              terminated=xp.asarray(np.asarray(term, bool)), truncated=xp.asarray(np.zeros(np.shape(term), bool)),
              obs_next=nxt)


def _example(B_, xp):
    return goal_tr(B_, xp, np.zeros(2), np.ones(2), np.zeros(2), -1.0, False)


class Pair:
    """A HER buffer in each package, driven by the same adds."""

    def __init__(self, total=E * C, n=E, horizon=8, future_k=4.0):
        env_t, env_j = GoalReach(), JGoalReach()
        self.t = HERVectorReplayBuffer(total, n, compute_reward_fn=env_t.compute_reward, horizon=horizon,
                                       future_k=future_k)
        self.j = JHERVRB(total_size=total, buffer_num=n, compute_reward_fn=env_j.compute_reward, horizon=horizon,
                         future_k=future_k)
        self.ts = self.t.init(_example(Batch, torch), device="cpu")
        self.js = self.j.init(_example(JBatch, jnp))

    def add(self, pos, goal, act, rew, term):
        self.t.add(self.ts, goal_tr(Batch, torch, pos, goal, act, rew, term))
        self.js, _ = self.j.add(self.js, goal_tr(JBatch, jnp, pos, goal, act, rew, term))

    def draws(self, key, batch=B):
        """JAX's draws of ``sample(key)``: the rows from k_idx, the plan's two uniforms from k_her."""
        k_idx, k_her = jax.random.split(key)
        k_off, k_mask = jax.random.split(k_her)
        return Draws(indices=t(self.j.sample_indices(self.js, k_idx, batch)).long(),
                     her_offset=t(jax.random.uniform(k_off, (batch,))),
                     her_relabel=t(jax.random.uniform(k_mask, (batch,))))


def _assert_batch_equal(tb, jb):
    for k in jb.keys():
        if isinstance(jb[k], JBatch):
            _assert_batch_equal(tb[k], jb[k])
        else:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def _random_episodes(p, rng, steps=30, n=E):
    """Random walks toward random goals; episodes end at random, some reach their goal."""
    for _ in range(steps):
        pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        goal = np.where(rng.random((n, 1)) < 0.2, pos + 0.01, rng.uniform(-1, 1, (n, 2))).astype(np.float32)
        p.add(pos, goal, rng.uniform(-1, 1, (n, 2)), -1.0 * np.ones(n), rng.random(n) < 0.2)


def test_goal_reach_matches_jax():
    jenv, tenv = JGoalReach(step_size=0.3), GoalReach(step_size=0.3)
    keys = jax.random.split(jax.random.key(0), 5)
    jstates, jobs = jax.vmap(jenv.reset)(keys)
    u = [jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[i], (2,)))(keys) for i in (0, 1)]
    s, obs = tenv.reset_from(t(u[0]), t(u[1]))
    _assert_batch_equal(obs, jobs)
    rng = np.random.default_rng(0)
    for _ in range(12):
        act = rng.uniform(-1.5, 1.5, (5, 2)).astype(np.float32)
        jstep = jax.vmap(jenv.step)(jstates, jnp.asarray(act), keys)
        step = tenv.step(s, t(act), None)
        _assert_batch_equal(step.obs, jstep.obs)
        for k in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(step, k).numpy(), np.asarray(getattr(jstep, k)), err_msg=k)
        jstates, s = jstep.state, step.state
    a = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    d = (a + rng.uniform(-0.15, 0.15, (64, 2))).astype(np.float32)
    np.testing.assert_array_equal(tenv.compute_reward(t(a), t(d)).numpy(), np.asarray(jenv.compute_reward(a, d)))
    gen_s, _ = tenv.reset(4, torch.Generator().manual_seed(0), "cpu")
    assert gen_s.pos.shape == (4, 2) and bool((gen_s.pos.abs() <= 1).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_relabel_plan_and_sample_match_jax(seed):
    """Short rings (C = 12) wrapped by 30 adds, random episode ends, a
    horizon of 5: the plan and the sampled batch equal to JAX's bits."""
    rng = np.random.default_rng(seed)
    p = Pair(horizon=5)
    _random_episodes(p, rng)
    key = jax.random.key(seed)
    draws = p.draws(key)
    jbatch, jidx = p.j.sample(p.js, key, B)
    tbatch, tidx = p.t.sample(p.ts, draws, B)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _assert_batch_equal(tbatch, jbatch)
    assert bool(tbatch.her_relabel.any()) and not bool(tbatch.her_relabel.all())
    jgoal, jrel = p.j.relabel_plan(p.js, jnp.asarray(draws.indices.numpy()), jax.random.split(key)[1])
    goal, rel = p.t.relabel_plan(p.ts, draws.indices, draws)
    np.testing.assert_array_equal(goal.numpy(), np.asarray(jgoal))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(jrel))


@pytest.mark.parametrize("n", [1, 3])
def test_n_step_gather_relabeled_matches_jax(n):
    rng = np.random.default_rng(2)
    p = Pair(horizon=6)
    _random_episodes(p, rng, steps=20)
    draws = p.draws(jax.random.key(3), batch=24)
    goal, rel = p.t.relabel_plan(p.ts, draws.indices, draws)
    jidx = jnp.asarray(draws.indices.numpy())
    jgoal, jrel = p.j.relabel_plan(p.js, jidx, jax.random.split(jax.random.key(3))[1])
    got = p.t.n_step_gather_relabeled(p.ts, draws.indices, n, goal, rel)
    want = p.j.n_step_gather_relabeled(p.js, jidx, n, jgoal, jrel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _one_episode_buffer():
    env = GoalReach()
    buf = HERVectorReplayBuffer(64, 1, compute_reward_fn=env.compute_reward, horizon=8, future_k=1e9)
    state = buf.init(_example(Batch, torch), device="cpu")
    for i in range(5):  # one 5-step episode walking right
        buf.add(state, goal_tr(Batch, torch, [[i * 0.1, 0.0]], [[5.0, 5.0]], [[0.0, 0.0]], [-1.0], [i == 4]))
    return env, buf, state


def test_her_relabel_semantics():
    """``tests/test_her.py::test_her_relabel_semantics`` on the port."""
    env, buf, state = _one_episode_buffer()
    batch, _ = buf.sample(state, torch.Generator().manual_seed(0), 32)
    ag = state.data.obs_next.achieved_goal[0, :5].numpy()
    for row in batch.obs.desired_goal.numpy():
        assert any(np.allclose(row, a) for a in ag), f"goal {row} not from the episode"
    want = env.compute_reward(batch.obs_next.achieved_goal, batch.obs.desired_goal)
    np.testing.assert_array_equal(batch.rew.numpy(), want.numpy())


def test_her_nstep_gather_relabeled_semantics():
    """``tests/test_her.py::test_her_nstep_gather_relabeled_semantics`` on the port."""
    env, buf, state = _one_episode_buffer()
    idx = torch.arange(3)
    new_goal, relabel = buf.relabel_plan(state, idx, torch.Generator().manual_seed(1))
    assert bool(relabel.all())
    n = 3
    rews, ends, term_idx = buf.n_step_gather_relabeled(state, idx, n, new_goal, relabel)
    assert rews.shape == (n, 3) and ends.shape == (n, 3)
    ag_next = state.data.obs_next.achieved_goal[0]
    for b in range(3):
        for j in range(n):
            assert float(rews[j, b]) == float(env.compute_reward(ag_next[b + j][None], new_goal[b][None])[0]), (b, j)
    np.testing.assert_array_equal(term_idx.numpy(), idx.numpy() + n - 1)
    batch, sidx = buf.sample(state, torch.Generator().manual_seed(2), 8)
    g, m = batch.pop("her_new_goal"), batch.pop("her_relabel")
    r1, _, _ = buf.n_step_gather_relabeled(state, sidx, 1, g, m)
    np.testing.assert_array_equal(batch.rew.numpy(), r1[0].numpy())


def test_plan_without_stored_obs_next_reads_the_next_row():
    """With ``ignore_obs_next`` the future goal is the next row's achieved goal, as in JAX."""
    env_t, env_j = GoalReach(), JGoalReach()
    kw = dict(horizon=4, future_k=2.0, ignore_obs_next=True)
    tb = HERReplayBuffer(16, env_t.compute_reward, num_envs=1, **kw)
    jb = JHERVRB(total_size=16, buffer_num=1, compute_reward_fn=env_j.compute_reward, **kw)
    ts, js = tb.init(_example(Batch, torch), device="cpu"), jb.init(_example(JBatch, jnp))
    rng = np.random.default_rng(4)
    for i in range(9):
        args = (rng.uniform(-1, 1, (1, 2)), rng.uniform(-1, 1, (1, 2)), np.zeros((1, 2)), [-1.0], [i % 4 == 3])
        tb.add(ts, goal_tr(Batch, torch, *args))
        js, _ = jb.add(js, goal_tr(JBatch, jnp, *args))
    idx = torch.arange(9)
    np.testing.assert_array_equal(tb._achieved_next(ts, idx).numpy(), np.asarray(jb._achieved_next(js, jnp.arange(9))))


# ---------------------------------------------------------------------------
# one HER-DDPG update, and HER-DDPG trained on GoalReach
# ---------------------------------------------------------------------------
class JGoalActor(fnn.Module):
    hidden: tuple = (128, 128)

    @fnn.compact
    def __call__(self, obs):
        return fnn.tanh(JMLP(self.hidden, 2)(jnp.concatenate([obs.observation, obs.desired_goal], axis=-1)))


class JGoalCritic(fnn.Module):
    hidden: tuple = (128, 128)

    @fnn.compact
    def __call__(self, obs, act):
        return JMLP(self.hidden, 1)(jnp.concatenate([obs.observation, obs.desired_goal, act], axis=-1))[:, 0]


class GoalActor(nn.Module):
    def __init__(self, hidden=(128, 128)):
        super().__init__()
        self.mlp = MLP(4, hidden, 2)

    def forward(self, obs):
        return torch.tanh(self.mlp(torch.cat([obs.observation, obs.desired_goal], dim=-1)))


class GoalCritic(nn.Module):
    def __init__(self, hidden=(128, 128)):
        super().__init__()
        self.mlp = MLP(6, hidden, 1)

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs.observation, obs.desired_goal, act], dim=-1))[:, 0]


def _goal_nets(tree) -> dict[str, torch.Tensor]:
    """``state_dict`` of the port's ``ModuleDict(actor, critic)`` from JAX's params."""
    out = {}
    for key in ("actor", "critic"):
        p = tree[key]["params"] if "params" in tree[key] else tree[key]
        out.update({f"{key}.{k}": v for k, v in mlp_params_from_flax(p["MLP_0"], prefix="mlp.").items()})
    return out


@pytest.mark.parametrize("n_step", [1, 3])
def test_one_her_ddpg_update_matches_jax(n_step):
    hid = (16, 16)
    rng = np.random.default_rng(5)
    p = Pair(horizon=6, future_k=3.0)
    _random_episodes(p, rng, steps=20)
    kw = dict(gamma=0.9, tau=0.05, n_step_return_horizon=n_step, action_scaling=False)
    jalgo = JDDPG(actor=JGoalActor(hid), critic=JGoalCritic(hid), action_space=JGoalReach().action_space,
                  policy_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=1e-3), exploration_noise=JGaussianNoise(0.3), **kw)
    talgo = DDPG(actor=GoalActor(hid), critic=GoalCritic(hid), action_space=GoalReach().action_space,
                 policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3),
                 exploration_noise=GaussianNoise(0.3), **kw)
    jts = jalgo.init(jax.random.key(0), _example(JBatch, jnp).obs)
    target = jax.tree.map(lambda x: x * np.float32(0.8) + np.float32(0.01), jts.target_params)
    jts = jts.replace(target_params=target)
    tts = talgo.init("cpu")
    tts.model.load_state_dict(_goal_nets(jax.tree.map(np.asarray, jts.params)))
    tts.target.load_state_dict(_goal_nets(jax.tree.map(np.asarray, target)))
    key = jax.random.key(6)
    k1 = jax.random.split(key, 3)[0]
    draws = p.draws(k1)
    jts2, js2, jstats = jalgo.update(jts, p.j, p.js, key, B)
    tts, _, tstats = talgo.update(tts, p.t, p.ts, draws, B)
    for k in ("critic_loss", "actor_loss", "td_error"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **TOL, err_msg=k)
    want = {f"model.{k}": v for k, v in _goal_nets(jax.tree.map(np.asarray, jts2.params)).items()}
    want.update({f"target.{k}": v for k, v in _goal_nets(jax.tree.map(np.asarray, jts2.target_params)).items()})
    got = {f"model.{k}": v for k, v in tts.model.state_dict().items()}
    got.update({f"target.{k}": v for k, v in tts.target.state_dict().items()})
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(g - w.numpy()) <= 2e-6) >= 0.999, k


def run_goal_ddpg(use_her: bool, epochs=8, n_step=1):
    """``tests/test_her.py:run_goal_ddpg`` on the port, on the CPU."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(0)
    env = GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)
    algo = DDPG(actor=GoalActor(), critic=GoalCritic(), action_space=env.action_space,
                policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3), gamma=0.98,
                tau=0.005, exploration_noise=GaussianNoise(sigma=0.3), action_scaling=False, n_step_return_horizon=n_step)
    if use_her:
        buffer = HERVectorReplayBuffer(50000, 8, compute_reward_fn=env.compute_reward, horizon=60, future_k=8.0)
    else:
        buffer = VectorReplayBuffer(50000, 8)
    bs = buffer.init(_example(Batch, torch), device="cpu")
    tc = DeviceCollector(VectorDeviceEnv(env, 8, device="cpu"), algo, buffer)
    ec = DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None)
    params = OffPolicyTrainerParams(max_epochs=epochs, epoch_num_steps=4000, test_step_num_episodes=20, batch_size=128,
                                    collection_step_num_env_steps=8, update_per_step=0.25, start_steps=2000,
                                    start_random=False, verbose=False, stop_fn=lambda r: r >= -12)
    return OffPolicyTrainer(algo, tc, ec, buffer, params).run(algo.init("cpu"), bs, torch.Generator().manual_seed(0))


@pytest.mark.slow
def test_her_ddpg_beats_sparse_reward():
    res = run_goal_ddpg(use_her=True)
    assert res.best_reward >= -20, f"HER best_reward {res.best_reward}"
    res2 = run_goal_ddpg(use_her=False, epochs=4)
    assert res.best_reward > res2.best_reward + 15, f"HER {res.best_reward} against no HER {res2.best_reward}"


@pytest.mark.slow
def test_her_ddpg_nstep_targets():
    res = run_goal_ddpg(use_her=True, n_step=3)
    assert res.best_reward >= -20, f"HER n_step=3 best_reward {res.best_reward}"
