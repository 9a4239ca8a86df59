"""The port's ``NormObs`` and its pooled statistics against the JAX package.

- ``NormObs(MoveToRightEnv)`` through both frameworks' collectors with an
  always-right policy (nothing random): every transition's normalized
  ``obs`` and ``obs_next`` and every env's running mean, variance and count
  after 20 steps, auto-resets included (the statistics carry through a
  reset), at atol 1e-6; with ``update_stats=False`` the statistics stay put.
- HalfCheetah from states handed across: per-env statistics drawn from a
  seed and the port's HalfCheetah observations (reset and three steps)
  through the port's ``NormObs`` and through the JAX ``NormObs`` over an env
  that replays the same observations, at atol 1e-5; the port's count
  advances by one per step and its statistics are the running mean and
  variance of the raw observations.
- ``merge_rms``, ``extract_pooled_rms`` and ``inject_rms``
  (``tests/test_collector.py:161-200``): pooled statistics equal the flat
  sample's, and against JAX's at rtol 1e-6; an env without ``NormObs`` gives
  None and an unchanged state.
- ``collect_episodes(rms=...)``: the test envs' statistics after the reset
  are the pooled train statistics in every slot, and the episodes match the
  JAX collector's with the same handoff.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.base import ActOut as JActOut
from tianshou_tpu.algorithm.base import Algorithm as JAlgorithm
from tianshou_tpu.algorithm.base import TrainState as JTrainState
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env import wrappers as jw
from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRightEnv
from tianshou_tpu_torch.algorithm.base import ActOut, Algorithm, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import wrappers as tw
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.mujoco import make
from tianshou_tpu_torch.env.testing import MoveToRightEnv
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ATOL = dict(rtol=0, atol=1e-6)


class JAlwaysRight(JAlgorithm):
    def init(self, key, obs_example):
        return JTrainState(params={}, target_params={}, opt_state={}, hparams=JBatch(), extra=JBatch(),
                           step=jnp.int32(0))

    def forward(self, ts, obs, key, state=None, deterministic=False):
        return JActOut(act=jnp.ones(obs.shape[0], jnp.int32), state=state, info=JBatch())


class AlwaysRight(Algorithm):
    def init(self, device=None):
        return TrainState(model=torch.nn.Module(), target=None, optim=None, hparams={},
                          step=torch.zeros((), dtype=torch.int64))

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        return ActOut(act=torch.ones(obs.shape[0], dtype=torch.int64), state=state, info=Batch())


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("update_stats", [True, False])
def test_normobs_over_move_to_right_matches_jax(update_stats):
    E, steps = 3, 20
    jenv = jw.NormObs(JMoveToRightEnv(size=3), update_stats=update_stats)
    jalgo = JAlwaysRight(jenv.action_space)
    jcoll = JCollector(jcore.VectorDeviceEnv(jenv, E), jalgo, None)
    jcs = jcoll.reset(jax.random.key(1))
    jcs, _, jout = jcoll.collect(jalgo.init(jax.random.key(0), jnp.zeros(1)), jcs, None, jax.random.key(2), steps,
                                 keep_rollout=True)
    env = tw.NormObs(MoveToRightEnv(size=3), update_stats=update_stats)
    algo = AlwaysRight(env.action_space)
    coll = DeviceCollector(VectorDeviceEnv(env, E, device="cpu"), algo, None)
    cs = coll.reset(torch.Generator())
    _, _, out = coll.collect(algo.init(), cs, None, torch.Generator(), steps, keep_rollout=True)
    for k in ("obs", "obs_next", "rew"):
        np.testing.assert_allclose(out.rollout[k].numpy(), _np(jout.rollout[k]), **ATOL, err_msg=k)
    np.testing.assert_array_equal(out.done.numpy(), _np(jout.done))
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(cs.env_state.rms, k).numpy(), _np(getattr(jcs.env_state.rms, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(out.done.sum()) >= E * 5  # several episodes per env, so several auto-resets
    want_count = 1e-4 + (1 + steps if update_stats else 0)  # the reset's observation, then one per step
    np.testing.assert_allclose(cs.env_state.rms.count.numpy(), np.full(E, want_count, np.float32), rtol=1e-6)
    cs2 = coll.reset(torch.Generator(), into=cs)
    assert cs2 is cs and bool((cs.env_state.rms.count < 2).all())  # a reset makes fresh statistics


class ReplayState(NamedTuple):
    env: jnp.ndarray
    t: jnp.ndarray


class JReplay(jcore.Env):
    """A single JAX env that plays back ``obs[t, env]`` (the port's HalfCheetah observations)."""

    def __init__(self, obs: np.ndarray) -> None:
        self.obs = jnp.asarray(obs)
        self.observation_space = jcore.Box(-np.inf, np.inf, (obs.shape[-1],))
        self.action_space = jcore.Box(-1.0, 1.0, (6,))
        self.max_episode_steps = None

    def reset(self, key):  # the key carries the env index
        env = jax.random.key_data(key)[-1].astype(jnp.int32)
        return ReplayState(env, jnp.int32(0)), self.obs[0, env]

    def step(self, state, action, key):
        t = state.t + 1
        return jcore.EnvStep(ReplayState(state.env, t), self.obs[t, state.env], jnp.float32(0), jnp.bool_(False),
                             jnp.bool_(False), JBatch())


def test_normobs_over_halfcheetah_from_handed_states():
    E, steps = 4, 3
    rng = np.random.default_rng(0)
    inner = make("HalfCheetah", physics_mode="plain")
    env = tw.NormObs(inner)
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset(E, g, torch.device("cpu"))
    dim = inner.observation_space.shape[0]
    rms = tw.RMSState(torch.from_numpy(rng.normal(0, 1, (E, dim)).astype(np.float32)),
                      torch.from_numpy(rng.uniform(0.2, 3.0, (E, dim)).astype(np.float32)),
                      torch.from_numpy(rng.uniform(1.0, 50.0, E).astype(np.float32)))
    state = tw.NormObsState(state.inner, rms)
    acts = rng.uniform(-1, 1, (steps, E, 6)).astype(np.float32)
    raw = [inner._obs(state.inner.q, state.inner.qd).numpy()]
    got_obs, s = [], state
    for a in acts:
        out = env.step(s, torch.from_numpy(a), g)
        s = out.state
        raw.append(inner._obs(s.inner.q, s.inner.qd).numpy())
        got_obs.append(out.obs.numpy())
    jenv = jw.NormObs(JReplay(np.stack(raw)))
    keys = jax.vmap(lambda i: jax.random.wrap_key_data(jnp.stack([jnp.uint32(0), i])))(jnp.arange(E, dtype=jnp.uint32))
    jstate, _ = jax.vmap(jenv.reset)(keys)
    jstate = jw.NormObsState(jstate.inner, jw.RMSState(*(jnp.asarray(x.numpy()) for x in rms)))
    jstep = jax.jit(jax.vmap(jenv.step))
    for i, a in enumerate(acts):
        jout = jstep(jstate, jnp.asarray(a), keys)
        jstate = jout.state
        np.testing.assert_allclose(got_obs[i], _np(jout.obs), rtol=0, atol=1e-5)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(s.rms, k).numpy(), _np(getattr(jstate.rms, k)), rtol=1e-5, atol=1e-5)
    # a fresh reset's statistics are the running mean and variance of the raw observations
    fresh, obs0 = env.reset(E, g, torch.device("cpu"))
    seq = [inner._obs(fresh.inner.q, fresh.inner.qd)]
    for a in acts:
        out = env.step(fresh, torch.from_numpy(a), g)
        fresh = out.state
        seq.append(inner._obs(fresh.inner.q, fresh.inner.qd))
    # the prior (mean 0, variance 1, count 1e-4) merged with the observations in float64
    x, c0, n = torch.stack(seq).double(), 1e-4, steps + 1
    mean = x.sum(0) / (c0 + n)
    var = (c0 + ((x - x.mean(0)) ** 2).sum(0) + c0 * n / (c0 + n) * x.mean(0) ** 2) / (c0 + n)
    np.testing.assert_allclose(fresh.rms.count.numpy(), np.full(E, c0 + n, np.float32), rtol=1e-6)
    np.testing.assert_allclose(fresh.rms.mean.numpy(), mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fresh.rms.var.numpy(), var.numpy(), rtol=1e-4, atol=1e-6)
    norm = ((x[-1] - mean) / torch.sqrt(var + 1e-8)).clamp(-10, 10)
    np.testing.assert_allclose(out.obs.numpy(), norm.numpy(), rtol=1e-4, atol=1e-4)


def test_merge_extract_inject_match_jax():
    rng = np.random.default_rng(0)
    xs = rng.normal(3.0, 2.0, (4, 50, 2))  # 4 envs x 50 samples x dim 2
    per_env = tw.RMSState(torch.from_numpy(xs.mean(1).astype(np.float32)),
                          torch.from_numpy(xs.var(1).astype(np.float32)), torch.full((4,), 50.0))
    pooled = tw.merge_rms(per_env)
    np.testing.assert_allclose(pooled.mean.numpy(), xs.reshape(-1, 2).mean(0), rtol=1e-5)
    np.testing.assert_allclose(pooled.var.numpy(), xs.reshape(-1, 2).var(0), rtol=1e-5)
    assert float(pooled.count) == 200.0
    jpooled = jw.merge_rms(jw.RMSState(*(jnp.asarray(x.numpy()) for x in per_env)))
    for a, b in zip(pooled, jpooled):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)

    env = tw.NormObs(MoveToRightEnv())
    state, _ = VectorDeviceEnv(env, 4, device="cpu").reset(torch.Generator())
    assert tw.extract_pooled_rms(env, state) is not None
    injected = tw.inject_rms(env, state, pooled)
    got = tw.extract_pooled_rms(env, injected)
    np.testing.assert_allclose(got.mean.numpy(), pooled.mean.numpy(), rtol=1e-6)
    assert injected.rms.mean.shape[0] == 4
    np.testing.assert_array_equal(injected.rms.mean[0].numpy(), injected.rms.mean[3].numpy())
    assert injected.inner is state.inner
    # through another wrapper
    stacked = tw.FrameStack(env, 2)
    sstate, _ = VectorDeviceEnv(stacked, 4, device="cpu").reset(torch.Generator())
    np.testing.assert_allclose(tw.extract_pooled_rms(stacked, tw.inject_rms(stacked, sstate, pooled)).var.numpy(),
                               pooled.var.numpy(), rtol=1e-6)
    plain = MoveToRightEnv()
    pstate, _ = VectorDeviceEnv(plain, 4, device="cpu").reset(torch.Generator())
    assert tw.extract_pooled_rms(plain, pstate) is None and tw.inject_rms(plain, pstate, pooled) is pstate


def test_collect_episodes_hands_the_pooled_statistics_to_the_test_envs():
    pooled = tw.RMSState(torch.tensor([1.5]), torch.tensor([0.25]), torch.tensor(300.0))
    env = tw.NormObs(MoveToRightEnv(size=4), update_stats=False)
    algo = AlwaysRight(env.action_space)
    coll = DeviceCollector(VectorDeviceEnv(env, 3, device="cpu"), algo, None, on_step_hook=lambda tr: seen.append(tr) or tr)
    seen = []
    got = coll.collect_episodes(algo.init(), torch.Generator(), 5, chunk_steps=4, rms=pooled)
    rms = coll._episodes.cstate.env_state.rms
    np.testing.assert_array_equal(rms.mean.numpy(), np.full((3, 1), 1.5, np.float32))
    np.testing.assert_array_equal(rms.var.numpy(), np.full((3, 1), 0.25, np.float32))
    np.testing.assert_array_equal(rms.count.numpy(), np.full(3, 300.0, np.float32))
    # the first step's next observation (position 1) under the handed statistics
    np.testing.assert_allclose(seen[0].obs_next.numpy(), np.full((3, 1), (1 - 1.5) / np.sqrt(0.25 + 1e-8), np.float32),
                               rtol=1e-6)
    jenv = jw.NormObs(JMoveToRightEnv(size=4), update_stats=False)
    jalgo = JAlwaysRight(jenv.action_space)
    want = JCollector(jcore.VectorDeviceEnv(jenv, 3), jalgo, None).collect_episodes(
        jalgo.init(jax.random.key(0), jnp.zeros(1)), jax.random.key(1), 5, chunk_steps=4,
        rms=jw.RMSState(jnp.asarray([1.5]), jnp.asarray([0.25]), jnp.float32(300.0)))
    assert got.n_collected_episodes == want.n_collected_episodes == 5
    assert got.n_collected_steps == want.n_collected_steps
    np.testing.assert_array_equal(got.returns, _np(want.returns))
    np.testing.assert_array_equal(got.lens, _np(want.lens))
