"""``bench.py``'s two configurations that the other parity tests do not hold at their ratios, the port against the
JAX package on the CPU at a small size.

- The DQN update burst (``bench.py:bench_atari_update_burst``): ``N_UPDATES`` updates of batch ``BATCH`` over a
  frame-stacked uint8 ring (3 envs x 32 slots of 36x36 frames, stack 4, the newest frame only, filled from a seed
  with numpy and wrapped), n = 3, the target synced every 3 updates, so after updates 3 and 6 of the burst. The JAX
  side runs ``algo.update`` in a ``lax.scan`` as ``bench.py:210-219`` does; the scan also returns each update's
  indices, gathered observations and n-step returns, drawn and computed from the update's key as ``algo.update``
  draws and computes them. The port runs ``algo.update`` as often with those indices handed over (``Draws``), on
  float32 weights converted by ``dqnet_params_from_flax``. Gathered observations bit-equal; returns, losses, TD
  errors and Q means at rtol 1e-4 / atol 1e-5 (``tests/test_torch_dqn.py``); the target synced on both sides and
  equal to JAX's as the weights are. The weights after the 8 Adam steps (lr 1e-3): at least 99.9% of each tensor
  within atol 2e-6 of JAX's, as ``tests/test_torch_dqn.py`` holds one step, and every weight within atol 1e-3, the
  learning rate: Adam's step is ``lr * m / (sqrt(v) + eps)``, so a weight whose gradient sits near zero takes a
  step of up to about lr set by the last bits of that gradient, and such a weight's difference carries through the
  later steps. Measured: 99.992% of ``cnn.fc.weight`` and at least 99.993% of every other tensor within 2e-6; one
  weight of the 51,200 of ``cnn.fc.weight`` beyond 2e-5 (1.6e-4 to 1.9e-4 between runs), every other within 5e-6.
- The PPO megastep of ``mujoco_ppo_16k`` (``bench.py:359-362``) at its ratios: ``NormObs(HalfCheetah())`` at
  E = 32 on the plain route of both packages (no Pallas kernel, no CUDA kernel on the CPU), a rollout of T = 16,
  then 4 passes of minibatches of E * T / 4 rows (16 gradient steps), 64x64 nets, Adam 3e-4 with
  ``max_grad_norm`` 0.5, return standardization and the value clip, as ``bench_mujoco_ppo`` builds it. The JAX side
  runs ``collect`` and ``update_rollout`` from the megastep's two keys; the port gets JAX's start state, the action
  noise each step drew from its key, and the minibatch permutations (``tests/test_torch_onpolicy.py:jax_perms``).
  The rollouts' terminations and truncations are equal, and their observations, actions and rewards and the
  normalization statistics agree at rtol = atol 5e-3, the tolerance of one physics step of the two packages
  (``tests/test_torch_mujoco_env.py``), which 16 steps through the policy keep (measured: at most 1.05e-3); that is
  looser than ``tests/test_torch_onpolicy.py``'s 1e-5 because the two packages' float32 dynamics part there. The
  update is held at ``tests/test_torch_onpolicy.py``'s tolerances on JAX's own rollout handed over: every weight and
  both Adam moments within 1e-4 and 99.9% of each tensor within 2e-6, the step counts equal, the stats and the
  return statistics at 1e-4 and 1e-5. The port's megastep on its own rollout ends with finite weights and the same
  step count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_dqn import HW, A, STACK, _algos, _buffers, _flat_params, _np_tree
from tests.test_torch_dqn import E as DQN_E
from tests.test_torch_onpolicy import adam_states, assert_weights_close, by_name, jax_perms, npy, t
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env.core import VectorDeviceEnv as JVectorDeviceEnv
from tianshou_tpu.env.mujoco import HalfCheetah as JHalfCheetah
from tianshou_tpu.env.wrappers import NormObs as JNormObs
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu_torch.algorithm.base import ActOut, Draws
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.mujoco import make
from tianshou_tpu_torch.env.mujoco.base import PhysState
from tianshou_tpu_torch.env.wrappers import NormObs, NormObsState, RMSState
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax, dqnet_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# the DQN burst: bench_atari_update_burst's shape at a small size
N_UPDATES, BATCH, SLOTS, FILL_STEPS, SYNC_EVERY = 8, 64, 32, 40, 3
TOL = dict(rtol=1e-4, atol=1e-5)
# the PPO megastep at mujoco_ppo_16k's ratios: T 16, repeat 4, batch E * T / 4
PPO_E, PPO_T, PPO_REPEAT = 32, 16, 4
PPO_BATCH = PPO_E * PPO_T // 4
OBS, ACT = 17, 6
PHYS_TOL = dict(rtol=5e-3, atol=5e-3)


def _filled_ring():
    """Both packages' frame-stacked rings with the same transitions: ``FILL_STEPS`` steps of 3 envs into 32 slots
    each (the ring wraps), random frames, actions, rewards and episode ends from a seed."""
    rng = np.random.default_rng(21)
    jb, js, tb, ts = _buffers(C=SLOTS)
    frame = (HW, HW, 1)
    for _ in range(FILL_STEPS):
        step = dict(
            obs=rng.integers(0, 256, (DQN_E, STACK) + frame, dtype=np.uint8),
            act=rng.integers(0, A, DQN_E).astype(np.int32),
            rew=rng.standard_normal(DQN_E).astype(np.float32),
            terminated=rng.random(DQN_E) < 0.1,
            truncated=rng.random(DQN_E) < 0.05,
            obs_next=rng.integers(0, 256, (DQN_E, STACK) + frame, dtype=np.uint8),
        )
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts


def test_dqn_update_burst_matches_jax():
    jb, js, tb, ts = _filled_ring()
    jalgo, jts, talgo, tts = _algos(n_step=3, target_update_freq=SYNC_EVERY)
    target0 = {k: v.copy() for k, v in _flat_params(tts.target.state_dict()).items()}

    def body(carry, key):
        jts, bs = carry
        k1, k2, _ = jax.random.split(key, 3)  # algo.update's own split
        idx = jb.sample_indices(bs, k1, BATCH)
        batch = jb.get(bs, idx, drop_keys=jalgo.update_sample_drop_keys)
        returns = jalgo.preprocess(jts, jb, bs, batch, idx, k2).returns
        jts, bs, stats = jalgo.update(jts, jb, bs, key, BATCH)
        return (jts, bs), (stats, idx, batch.obs, returns)

    (jts2, _), (jstats, jidx, jobs, jret) = jax.jit(
        lambda c, k: jax.lax.scan(body, c, jax.random.split(k, N_UPDATES)))((jts, js), jax.random.key(3))

    for i in range(N_UPDATES):
        idx = torch.from_numpy(np.asarray(jidx[i]).astype(np.int64))
        batch = tb.get(ts, idx, drop_keys=talgo.update_sample_drop_keys)
        np.testing.assert_array_equal(batch.obs.numpy(), np.asarray(jobs[i]), err_msg=f"update {i}")
        returns = talgo.preprocess(tts, tb, ts, batch, idx, torch.Generator()).returns
        np.testing.assert_allclose(returns.numpy(), np.asarray(jret[i]), **TOL, err_msg=f"update {i}")
        tts, ts, stats = talgo.update(tts, tb, ts, Draws(indices=idx), BATCH)
        for k in ("loss", "q_mean", "td_error"):
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k][i]), **TOL, err_msg=f"{k}, update {i}")
    assert int(tts.step) == int(jts2.step) == N_UPDATES
    got_target = _flat_params(tts.target.state_dict())
    assert not all(np.array_equal(got_target[k], w) for k, w in target0.items())  # synced inside the burst
    for got, want in ((_flat_params(tts.model.state_dict()), jts2.params["model"]),
                      (got_target, jts2.target_params["model"])):
        for k, w in dqnet_params_from_flax(_np_tree(want)).items():
            np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=1e-3, err_msg=k)
            assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k


class HandedPPO(PPO):
    """The port's PPO acting with handed standard normals (the JAX key's draws), one ``[E, A]`` array a step."""

    handed: list

    def forward(self, ts, obs, generator=None, state=None, deterministic=False):
        return ActOut(act=self._dist(ts.model, obs).from_noise(self.handed.pop(0)), state=state, info=Batch())


def _to_port_state(jstate):
    """A JAX ``NormObs(HalfCheetah)`` env state as the port's."""
    inner, rms = jstate.inner, jstate.rms
    return NormObsState(PhysState(t(inner.q), t(inner.qd), t(inner.t)), RMSState(t(rms.mean), t(rms.var), t(rms.count)))


def test_ppo_megastep_at_the_16k_ratios_matches_jax():
    kw = dict(return_standardization=True, value_clip=True)
    jalgo = JPPO(actor=jcont.ContinuousActorProbabilistic((64, 64), ACT),
                 critic=jcont.ContinuousCritic((64, 64), use_action=False), action_space=JHalfCheetah().action_space,
                 optim=JAdam(lr=3e-4, max_grad_norm=0.5), **kw)
    talgo = HandedPPO(actor=continuous.ContinuousActorProbabilistic((64, 64), ACT, input_dim=OBS),
                      critic=continuous.ContinuousCritic((64, 64), use_action=False, input_dim=OBS),
                      action_space=make("HalfCheetah").action_space,
                      optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    params = npy(jts.params)

    def port_state():
        ts = talgo.init("cpu")
        ts.model.load_state_dict(actor_critic_params_from_flax(params, ts.model))
        return ts

    jcoll = JCollector(JVectorDeviceEnv(JNormObs(JHalfCheetah()), PPO_E), jalgo, None)
    jc = jcoll.reset(jax.random.key(1))
    k_c, k_u = jax.random.split(jax.random.key(2))  # bench_mujoco_ppo's megastep splits its key so
    jc2, _, jout = jcoll.collect(jts, jc, None, k_c, PPO_T, training=True, keep_rollout=True)
    jts2, jstats = jalgo.update_rollout(jts, jout.rollout, k_u, repeat=PPO_REPEAT, batch_size=PPO_BATCH)
    perm = jax_perms(k_u, PPO_REPEAT, PPO_BATCH, n=PPO_T * PPO_E)
    assert perm.shape == (PPO_REPEAT, 4, PPO_BATCH)

    # the rollout, from JAX's start state with JAX's action noise (Normal.sample of each step's k_act)
    coll = DeviceCollector(VectorDeviceEnv(NormObs(make("HalfCheetah")), PPO_E, device="cpu"), talgo, None)
    cs = coll.reset(torch.Generator())._replace(env_state=_to_port_state(jc.env_state), obs=t(jc.obs))
    talgo.handed = [t(jax.random.normal(jax.random.split(k, 4)[0], (PPO_E, ACT), jnp.float32))
                    for k in jax.random.split(k_c, PPO_T)]
    tts = port_state()
    cs2, _, out = coll.collect(tts, cs, None, torch.Generator(), PPO_T, keep_rollout=True)
    assert talgo.handed == []
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(out.rollout[k].numpy(), np.asarray(jout.rollout[k]), err_msg=k)
    for k in ("obs", "act", "rew", "obs_next"):
        np.testing.assert_allclose(out.rollout[k].numpy(), np.asarray(jout.rollout[k]), **PHYS_TOL, err_msg=k)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(cs2.env_state.rms, k).numpy(), np.asarray(getattr(jc2.env_state.rms, k)),
                                   **PHYS_TOL, err_msg=f"rms {k}")

    # the update on JAX's rollout, with JAX's permutations
    _, stats = talgo.update_rollout(tts, Batch({k: t(v) for k, v in jout.rollout.items()}), None, PPO_REPEAT,
                                    PPO_BATCH, perm=perm)
    model = tts.model
    assert_weights_close(model.state_dict(), actor_critic_params_from_flax(npy(jts2.params), model))
    adam = adam_states(jts2)
    params_ = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = by_name(model, [tts.optim.state[p][ours] for p in params_])
        assert_weights_close(got, actor_critic_params_from_flax(npy(theirs), model))
    n_grad = talgo.rollout_grad_steps(PPO_T * PPO_E, PPO_REPEAT, PPO_BATCH)
    assert n_grad == 16 and int(tts.step) == int(jts2.step) == int(adam.count) == n_grad
    for k in tts.extra:
        np.testing.assert_allclose(float(tts.extra[k]), float(jts2.extra[k]), rtol=1e-5, err_msg=k)
    jstats = dict(jstats.items())
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)

    # the port's megastep on its own rollout: the same count of steps, finite weights
    own = port_state()
    talgo.update_rollout(own, out.rollout, None, PPO_REPEAT, PPO_BATCH, perm=perm)
    assert int(own.step) == n_grad
    assert all(bool(torch.isfinite(p).all()) for p in own.model.parameters())
