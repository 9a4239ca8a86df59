"""gSDE (generalized state-dependent exploration, arXiv:2005.05719) in the
port against the JAX package, on the CPU.

- The gSDE actor (``ContinuousActorProbabilistic(sde=True)``, plain and
  with the PPO init) against flax through ``actor_critic_params_from_flax``:
  ``mu``, ``sigma(s)`` and ``feat`` at atol 1e-6.
- ``forward`` with handed noise (JAX's draw from ``fold_in(key, 0x5DE)``):
  at a resample step (count 0 and count 4 with ``sde_sample_freq`` 4) the
  fresh noise is taken, between resamples the carried one; actions at atol
  1e-6, the state's noise bit-exact, counts advanced by one; the
  deterministic branch returns ``mu`` and the state as it was.
- The marginal-moments case of ``tests/test_sde.py:34-65``: 4,000 noise
  draws give the mean ``mu`` (atol 0.05) and the std ``sigma(s)`` (rtol 0.12).
- The collector against the JAX collector on a deterministic continuous env
  defined here in both frameworks, the JAX key's draws handed over (the
  per-chunk refresh from ``fold_in(key, 0x5DE)``, each step's fresh noise
  and reset noise): two chunks of 7 steps over 5 envs, the rollouts' actions
  at atol 1e-5, terminations and truncations exactly, and the carried noise
  and counts bit-exact after each chunk (count 0 exactly in the envs that
  finished at the chunk's last step). The episode collection resets the
  carry where an episode ends, as the JAX package's does: the same returns
  and lengths.
- One PPO+gSDE ``update_rollout`` with JAX's minibatch indices: weights and
  Adam moments by ``tests/test_torch_onpolicy.py``'s rule, stats at 1e-4.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_onpolicy import A, OBS, adam_states, assert_weights_close, by_name, jax_perms, make_rollout, npy, t
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

HID = (16, 16)


class HandedPPO(PPO):
    """The port's PPO taking its gSDE noise draws from a queue (the JAX key's draws)."""

    handed: list

    def _sde_eps(self, num_envs, generator, device):
        eps = self.handed.pop(0)
        assert eps.shape == (num_envs, self.actor.hidden_sizes[-1], self.actor.action_dim)
        return eps.to(device)


def make_pair(obs_dim=OBS, act_dim=A, ppo_init=True, sigma_init=-1.0, handed=False, **kw):
    j_actor = jcont.ContinuousActorProbabilistic(HID, act_dim, ppo_init=ppo_init, sde=True, sigma_init=sigma_init)
    t_actor = continuous.ContinuousActorProbabilistic(HID, act_dim, ppo_init=ppo_init, sde=True, sigma_init=sigma_init,
                                                      input_dim=obs_dim)
    j_critic = jcont.ContinuousCritic(HID, use_action=False, ppo_init=ppo_init)
    t_critic = continuous.ContinuousCritic(HID, use_action=False, ppo_init=ppo_init, input_dim=obs_dim)
    jalgo = JPPO(actor=j_actor, critic=j_critic, action_space=jcore.Box(-1.0, 1.0, (act_dim,)),
                 optim=JAdam(lr=1e-3, max_grad_norm=0.5), **kw)
    talgo = (HandedPPO if handed else PPO)(actor=t_actor, critic=t_critic, action_space=tcore.Box(-1.0, 1.0, (act_dim,)),
                                           optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(obs_dim))
    params = npy(jts.params)  # log_sigma_mat off its constant init
    params["actor"]["params"]["log_sigma_mat"] = np.linspace(-1.5, 0.5, HID[-1] * act_dim, dtype=np.float32).reshape(
        HID[-1], act_dim)
    jts = jts.replace(params=jax.tree.map(jnp.asarray, params))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(params, tts.model))
    return jalgo, jts, talgo, tts


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ppo_init", [True, False], ids=["ppo_init", "plain"])
def test_sde_actor_matches_flax(ppo_init):
    jalgo, jts, talgo, tts = make_pair(ppo_init=ppo_init)
    obs = np.random.default_rng(0).normal(0, 1, (7, OBS)).astype(np.float32)
    want = jalgo.actor.apply(jts.params["actor"], jnp.asarray(obs))
    with torch.no_grad():
        got = tts.model["actor"](t(obs))
    assert len(got) == 3 and got[2].shape == (7, HID[-1])
    for g, w, name in zip(got, want, ("mu", "sigma", "feat")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    fresh = continuous.ContinuousActorProbabilistic(HID, A, ppo_init=ppo_init, sde=True, sigma_init=-2.0, input_dim=OBS)
    assert fresh.log_sigma_mat.shape == (HID[-1], A) and bool((fresh.log_sigma_mat == -2.0).all())
    assert not hasattr(fresh, "log_sigma") and not hasattr(fresh, "sigma")


def _jax_state(eps, count):
    return JBatch(eps=jnp.asarray(eps), count=jnp.asarray(count, jnp.int32))


def test_forward_with_handed_noise_matches_jax():
    jalgo, jts, talgo, tts = make_pair(handed=True, sde_sample_freq=4, deterministic_eval=True)
    rng = np.random.default_rng(1)
    obs = rng.normal(0, 1, (5, OBS)).astype(np.float32)
    carried = rng.normal(0, 1, (5, HID[-1], A)).astype(np.float32)
    count = np.array([0, 1, 3, 4, 6], np.int32)  # resample where count % 4 == 0: envs 0 and 3
    key = jax.random.key(7)
    out = jalgo.forward(jts, jnp.asarray(obs), key, state=_jax_state(carried, count))
    talgo.handed = [t(np.asarray(jalgo._sde_eps(5, jax.random.fold_in(key, 0x5DE))))]
    got = talgo.forward(tts, t(obs), None, state=Batch(eps=t(carried), count=t(count)))
    assert talgo.handed == []
    np.testing.assert_allclose(got.act.numpy(), np.asarray(out.act), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.state.eps.numpy(), np.asarray(out.state.eps))
    np.testing.assert_array_equal(got.state.count.numpy(), count + 1)
    assert got.state.count.dtype == torch.int32
    kept = count % 4 != 0
    np.testing.assert_array_equal(got.state.eps.numpy()[kept], carried[kept])
    assert not np.array_equal(got.state.eps.numpy()[~kept], carried[~kept])
    # deterministic: mu, the state unchanged
    state = Batch(eps=t(carried), count=t(count))
    det = talgo.forward(tts, t(obs), None, state=state, deterministic=True)
    np.testing.assert_allclose(det.act.numpy(), np.asarray(jalgo.forward(
        jts, jnp.asarray(obs), key, state=_jax_state(carried, count), deterministic=True).act), rtol=0, atol=1e-6)
    assert det.state is state
    # no carried state: a sample of the marginal Normal(mu, sigma(s))
    mu, sigma, _ = tts.model["actor"](t(obs))
    g = torch.Generator().manual_seed(3)
    free = talgo.forward(tts, t(obs), torch.Generator().manual_seed(3)).act
    torch.testing.assert_close(free, (mu + sigma * torch.randn(mu.shape, generator=g)).detach(), rtol=0, atol=0)


def test_marginal_moments():
    """``tests/test_sde.py:34-65`` on the port: ``mu + feat^T (eps * exp(log_sigma))``
    is marginally ``Normal(mu, sigma(s))``."""
    torch.manual_seed(0)
    algo = PPO(actor=continuous.ContinuousActorProbabilistic(HID, 1, ppo_init=True, sde=True, sigma_init=-1.0,
                                                             input_dim=3),
               critic=continuous.ContinuousCritic(HID, use_action=False, ppo_init=True, input_dim=3),
               action_space=tcore.Box(-2.0, 2.0, (1,)), optim=AdamOptimizerFactory(lr=3e-4))
    ts = algo.init("cpu")
    obs = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    mu, sigma, feat = ts.model["actor"](obs)
    assert feat.shape == (4, 16) and sigma.shape == mu.shape == (4, 1) and bool((sigma > 0).all())
    g = torch.Generator().manual_seed(2)
    n = 4000
    one = torch.ones(4, dtype=torch.int32)
    acts = torch.stack([algo.forward(ts, obs, None, state=Batch(eps=algo._sde_eps(4, g, "cpu"), count=one)).act
                        for _ in range(n)])
    np.testing.assert_allclose(acts.mean(0).numpy(), mu.detach().numpy(), atol=0.05)
    np.testing.assert_allclose(acts.std(0, correction=0).numpy(), sigma.detach().numpy(), rtol=0.12)
    assert bool(torch.isfinite(algo._dist(ts.model, obs).log_prob(acts[0])).all())


# ---------------------------------------------------------------------------
# a deterministic continuous env in both frameworks: x drifts with the action; the episode
# terminates where |x| > 0.6 and is truncated at step 5
class JDriftState(NamedTuple):
    x: jnp.ndarray
    t: jnp.ndarray


class JDrift(jcore.Env):
    observation_space = jcore.Box(-10.0, 10.0, (3,))
    action_space = jcore.Box(-1.0, 1.0, (2,))

    def _obs(self, s):
        return jnp.stack([s.x, s.t.astype(jnp.float32) * 0.1, jnp.float32(1.0)])

    def reset(self, key):
        s = JDriftState(jnp.float32(0.0), jnp.int32(0))
        return s, self._obs(s)

    def step(self, state, action, key):
        x = state.x * 0.8 + 0.5 * (action[0] - 0.5 * action[1])
        s = JDriftState(x, state.t + 1)
        term = jnp.abs(x) > 0.6
        return jcore.EnvStep(s, self._obs(s), -x * x, term, (s.t >= 5) & ~term, JBatch())


class DriftState(NamedTuple):
    x: torch.Tensor
    t: torch.Tensor


class Drift(tcore.Env):
    observation_space = tcore.Box(-10.0, 10.0, (3,))
    action_space = tcore.Box(-1.0, 1.0, (2,))

    def _obs(self, s):
        return torch.stack([s.x, s.t.to(torch.float32) * 0.1, torch.ones_like(s.x)], dim=1)

    def reset(self, num_envs, generator, device):
        s = DriftState(torch.zeros(num_envs, device=device), torch.zeros(num_envs, dtype=torch.int32, device=device))
        return s, self._obs(s)

    def step(self, state, action, generator):
        x = state.x * 0.8 + 0.5 * (action[:, 0] - 0.5 * action[:, 1])
        s = DriftState(x, state.t + 1)
        term = x.abs() > 0.6
        return tcore.EnvStep(s, self._obs(s), -x * x, term, (s.t >= 5) & ~term, Batch())


def _jax_chunk_draws(jalgo, E, key, n_steps):
    """The noise a JAX collect chunk draws from ``key``, in the port's order:
    the refresh, then each step's fresh noise and reset noise."""
    draws = [jalgo._sde_eps(E, jax.random.fold_in(key, 0x5DE))]
    for k in jax.random.split(key, n_steps):
        k_act, _, _, k_reset = jax.random.split(k, 4)
        draws.append(jalgo._sde_eps(E, jax.random.fold_in(k_act, 0x5DE)))
        draws.append(jalgo._sde_eps(E, jax.random.fold_in(k_reset, 1)))
    return [t(np.asarray(d)) for d in draws]


def test_collector_resets_and_refreshes_the_noise_as_jax():
    E, steps = 5, 7
    jalgo, jts, talgo, tts = make_pair(obs_dim=3, act_dim=2, handed=True, sde_sample_freq=3, sigma_init=-0.5)
    jcoll = JCollector(jcore.VectorDeviceEnv(JDrift(), E), jalgo, None)
    coll = DeviceCollector(tcore.VectorDeviceEnv(Drift(), E, device="cpu"), talgo, None)
    jcs = jcoll.reset(jax.random.key(1))
    cs = coll.reset(torch.Generator())
    assert cs.policy_state.eps.shape == (E, HID[-1], 2) and cs.policy_state.count.dtype == torch.int32
    ends = 0
    for chunk in range(2):
        key = jax.random.key(10 + chunk)
        jcs, _, jout = jcoll.collect(jts, jcs, None, key, steps, training=True, keep_rollout=True)
        talgo.handed = _jax_chunk_draws(jalgo, E, key, steps)
        cs2, _, out = coll.collect(tts, cs, None, torch.Generator(), steps, keep_rollout=True)
        assert cs2 is cs and talgo.handed == []
        np.testing.assert_allclose(out.rollout.act.numpy(), np.asarray(jout.rollout.act), rtol=0, atol=1e-5)
        for k in ("terminated", "truncated"):
            np.testing.assert_array_equal(out.rollout[k].numpy(), np.asarray(jout.rollout[k]))
        np.testing.assert_array_equal(cs.policy_state.eps.numpy(), np.asarray(jcs.policy_state.eps))
        np.testing.assert_array_equal(cs.policy_state.count.numpy(), np.asarray(jcs.policy_state.count))
        done = out.done.numpy()
        np.testing.assert_array_equal(cs.policy_state.count.numpy() == 0, done[-1])
        ends += int(done.sum())
    assert ends >= 2 * E  # every env finished an episode in every chunk


def test_episode_collection_resets_the_noise_as_jax():
    E, n_episodes = 3, 5
    jalgo, jts, talgo, tts = make_pair(obs_dim=3, act_dim=2, handed=True, sde_sample_freq=2, sigma_init=-0.5)
    jcoll = JCollector(jcore.VectorDeviceEnv(JDrift(), E), jalgo, None)
    coll = DeviceCollector(tcore.VectorDeviceEnv(Drift(), E, device="cpu"), talgo, None)
    key = jax.random.key(3)
    want = jcoll.collect_episodes(jts, key, n_episodes=n_episodes, chunk_steps=6)
    key, _ = jax.random.split(key)
    draws = []
    for _ in range(2):  # at most two chunks
        key, ck = jax.random.split(key)
        draws += _jax_chunk_draws(jalgo, E, ck, 6)[1:]  # the episode collection refreshes nothing
    talgo.handed = draws
    got = coll.collect_episodes(tts, torch.Generator(), n_episodes=n_episodes, chunk_steps=6)
    assert got.n_collected_episodes == want.n_collected_episodes == n_episodes
    assert got.n_collected_steps == want.n_collected_steps
    np.testing.assert_allclose(got.returns, np.asarray(want.returns), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.lens, np.asarray(want.lens))


# ---------------------------------------------------------------------------
def test_ppo_sde_update_rollout_matches_jax():
    jalgo, jts, talgo, tts = make_pair(value_clip=True, return_standardization=True)
    jroll, troll = make_rollout()
    key = jax.random.key(5)
    jts2, jstats = jalgo.update_rollout(jts, jroll, key, repeat=2, batch_size=16)
    _, stats = talgo.update_rollout(tts, troll, None, 2, 16, perm=jax_perms(key, 2, 16))
    model = tts.model
    assert_weights_close(model.state_dict(), actor_critic_params_from_flax(npy(jts2.params), model))
    adam = adam_states(jts2)
    params = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        assert_weights_close(by_name(model, [tts.optim.state[p][ours] for p in params]),
                             actor_critic_params_from_flax(npy(theirs), model))
    assert int(tts.step) == int(jts2.step) == 4
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)
