"""The continuous offline family of the port (``ImitationLearning`` on
actions, ``TD3BC``, ``BCQ`` with its ``Perturbation`` and ``VAE`` nets,
``CQL`` with and without its Lagrange multiplier) against the JAX package.

Both packages get the same buffer (the same numpy transitions over 4 rings:
3-wide observations, 1- or 2-wide actions), the same weights (flax's,
carried across by ``actor_critic_params_from_flax``, which knows the BCQ
nets; the target nets moved away from the online ones) and the JAX key's own
draws, handed to the port as ``Draws``: the JAX update splits its key into k1
(the rows), k2 (``preprocess``: TD3's smoothing noise, CQL's next action) and
k3 (the gradient step: BCQ splits it into the VAE's, the target decode's and
the actor decode's normals; CQL into the actor's normals, the random actions
and the current and next candidates' normals).

Tolerances:
- nets (``Perturbation``, ``VAE`` and its decode), returns, losses and TD
  errors: rtol 1e-5 / atol 1e-6, the family's float32 rule; CQL's losses
  rtol 1e-5 / atol 1e-5 (a logsumexp over 30 candidates of values near 10);
- the train state after one update (every weight and target, ``log_alpha``
  and ``log_cql_alpha``): all within 2e-5 and 99.9% of each tensor within
  2e-6, ``tests/test_torch_dqn.py``'s rule for Adam's first step;
- at a delayed TD3+BC step the actor and its Adam state bit-identical to
  what they were; acting: BC's and BCQ's actions at rtol 1e-5 / atol 1e-6;
- 40 TD3+BC or CQL updates in a row: losses rtol 1e-4 / atol 1e-5, the
  final state within 2e-4 (``test_many_updates_track_jax`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.imitation.bc import ImitationLearning as JBC
from tianshou_tpu.algorithm.imitation.bcq import BCQ as JBCQ
from tianshou_tpu.algorithm.imitation.cql import CQL as JCQL
from tianshou_tpu.algorithm.imitation.td3_bc import TD3BC as JTD3BC
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu_torch.algorithm.base import Draws, optimizer_tensors
from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
from tianshou_tpu_torch.algorithm.imitation.cql import CQL
from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import (
    actor_critic_params_from_flax,
    continuous_actor_det_params_from_flax,
    perturbation_params_from_flax,
    vae_params_from_flax,
)
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, E, C, B, HID, LATENT, N_DEC, R = 3, 4, 16, 12, (16, 16), 2, 5, 4
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _example(act_dim, jax_side):
    ex = dict(obs=np.zeros(OBS, np.float32), act=np.zeros(act_dim, np.float32), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros(OBS, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def _fill(act_dim):
    rng = np.random.default_rng(act_dim)
    jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js, ts = jb.init(_example(act_dim, True)), tb.init(_example(act_dim, False), device="cpu")
    for _ in range(13):
        term = rng.random(E) < 0.15
        step = dict(obs=rng.standard_normal((E, OBS)).astype(np.float32),
                    act=rng.uniform(-1.0, 1.0, (E, act_dim)).astype(np.float32),
                    rew=rng.standard_normal(E).astype(np.float32), terminated=term,
                    truncated=(rng.random(E) < 0.1) & ~term, obs_next=rng.standard_normal((E, OBS)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts, rng.integers(0, E * 13, B)


@pytest.fixture(scope="module")
def rings():
    return {1: _fill(1), 2: _fill(2)}


def _pair(kind, act_dim, **kw):
    """(JAX algo, JAX train state, port algo, port train state) with the same weights."""
    jspace, tspace = jcore.Box(-2.0, 2.0, (act_dim,)), tcore.Box(-2.0, 2.0, (act_dim,))
    opts = dict(policy_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=1e-3))
    topts = dict(policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3))
    j_critic = jcont.ContinuousCritic(HID)
    t_critic = continuous.ContinuousCritic(HID, input_dim=OBS, action_dim=act_dim)
    common = dict(gamma=0.9, tau=0.05)
    if kind == "td3bc":
        jalgo = JTD3BC(actor=jcont.ContinuousActorDeterministic(HID, act_dim), critic=j_critic, action_space=jspace,
                       alpha=2.5, **opts, **common, **kw)
        talgo = TD3BC(actor=continuous.ContinuousActorDeterministic(HID, act_dim, input_dim=OBS), critic=t_critic,
                      action_space=tspace, alpha=2.5, **topts, **common, **kw)
    elif kind == "cql":
        jalgo = JCQL(actor=jcont.ContinuousActorProbabilistic(HID, act_dim, conditioned_sigma=True), critic=j_critic,
                     action_space=jspace, num_repeat_actions=R, cql_alpha_lr=1e-2, **opts, **common, **kw)
        talgo = CQL(actor=continuous.ContinuousActorProbabilistic(HID, act_dim, conditioned_sigma=True, input_dim=OBS),
                    critic=t_critic, action_space=tspace, num_repeat_actions=R, cql_alpha_lr=1e-2, **topts, **common,
                    **kw)
    else:
        bcq = dict(forward_sampled_times=N_DEC, num_sampled_action=N_DEC, lmbda=0.75, **common)
        jalgo = JBCQ(actor_perturbation=jcont.Perturbation(HID, act_dim, max_action=1.0, phi=0.05), critic=j_critic,
                     vae=jcont.VAE((16,), (16,), act_dim, LATENT, max_action=1.0), action_space=jspace,
                     actor_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=1e-3), vae_optim=JAdam(lr=1e-3), **bcq)
        talgo = BCQ(actor_perturbation=continuous.Perturbation(HID, act_dim, max_action=1.0, phi=0.05, input_dim=OBS),
                    critic=t_critic, vae=continuous.VAE((16,), (16,), act_dim, LATENT, max_action=1.0, input_dim=OBS),
                    action_space=tspace, actor_optim=AdamOptimizerFactory(lr=1e-3),
                    critic_optim=AdamOptimizerFactory(lr=1e-3), vae_optim=AdamOptimizerFactory(lr=1e-3), **bcq)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    params = _np(jts.params)
    for name, value in (("log_alpha", -0.7), ("log_cql_alpha", 0.3)):  # away from 0
        if name in params:
            params[name] = np.float32(value)
    target = jax.tree.map(lambda x: (x * np.float32(0.8) + np.float32(0.01)).astype(np.float32), _np(jts.target_params))
    jts = jts.replace(params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(params, tts.model))
    tts.target.load_state_dict(actor_critic_params_from_flax(target, tts.target))
    return jalgo, jts, talgo, tts


def _draws(kind, key, act_dim, idx):
    """Every draw of the JAX update from ``key``, as ``Draws``."""
    _, k2, k3 = jax.random.split(key, 3)
    draws = Draws(indices=_t(idx).long())
    if kind == "td3bc":
        draws.target = _t(jax.random.normal(k2, (B, act_dim)))
    elif kind == "cql":
        k_actor, k_rand, k_cur, k_next = jax.random.split(k3, 4)
        draws.target = _t(jax.random.normal(k2, (B, act_dim)))
        draws.actor = _t(jax.random.normal(k_actor, (B, act_dim)))
        draws.cql_rand = _t(jax.random.uniform(k_rand, (B * R, act_dim), minval=-1.0, maxval=1.0))
        draws.cql_cur = _t(jax.random.normal(k_cur, (B * R, act_dim)))
        draws.cql_next = _t(jax.random.normal(k_next, (B * R, act_dim)))
    else:
        k_vae, k_dec, k_actor = jax.random.split(k3, 3)
        draws.vae = _t(jax.random.normal(k_vae, (B, LATENT)))
        draws.decode_next = _t(jax.random.normal(k_dec, (B * N_DEC, LATENT)))
        draws.decode_actor = _t(jax.random.normal(k_actor, (B, LATENT)))
    return draws


def _state(ts):
    out = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target.state_dict().items()})
    return out


def _jax_state(jts, ts):
    out = {f"model.{k}": v for k, v in actor_critic_params_from_flax(_np(jts.params), ts.model).items()}
    out.update({f"target.{k}": v for k, v in actor_critic_params_from_flax(_np(jts.target_params), ts.target).items()})
    return out


def _hold(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(g - w) <= 2e-6) >= 0.999, k


UPDATE_CASES = {
    "td3bc_step0": ("td3bc", 2, 0, {}, TOL),
    "td3bc_step1_delayed": ("td3bc", 2, 1, {}, TOL),
    "bcq": ("bcq", 2, 0, {}, TOL),
    "cql_lagrange": ("cql", 2, 0, dict(with_lagrange=True, lagrange_threshold=1.0, temperature=0.7), dict(rtol=1e-5, atol=1e-5)),
    "cql_fixed_weight_fixed_alpha": ("cql", 1, 0, dict(with_lagrange=False, cql_weight=2.0, alpha=0.2),
                                     dict(rtol=1e-5, atol=1e-5)),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_one_update_matches_jax(rings, case):
    kind, act_dim, step, kw, tol = UPDATE_CASES[case]
    jb, js, tb, ts, idx = rings[act_dim]
    jalgo, jts, talgo, tts = _pair(kind, act_dim, **kw)
    jts = jts.replace(step=jnp.int32(step))
    tts.step.fill_(step)
    key = jax.random.key(3)
    _, k2, k3 = jax.random.split(key, 3)
    jidx = jnp.asarray(idx)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, k2))(jts, js, jb.get(js, jidx))
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, k3)
    actor_before = [v.clone() for v in optimizer_tensors(tts.optim["actor"])]
    before = {k: v.clone() for k, v in _state(tts).items()}
    out = talgo.update(tts, tb, ts, _draws(kind, key, act_dim, idx), B)
    assert out[0] is tts and out[1] is ts
    tstats = out[2]
    assert set(tstats.keys()) == set(jstats.keys())
    for k in tstats.keys():
        assert not tstats[k].requires_grad, k
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **tol, err_msg=k)
    assert int(tts.step) == int(jts2.step) == step + 1
    _hold(_state(tts), _jax_state(jts2, tts))
    delayed = case.endswith("delayed")
    for k, v in before.items():  # every net and target moves, but a delayed step's actor
        moved = not torch.equal(_state(tts)[k], v)
        assert moved != (delayed and k.startswith("model.actor.")), k
    if delayed:
        assert all(torch.equal(a, b) for a, b in zip(actor_before, optimizer_tensors(tts.optim["actor"])))
    if kind == "cql":
        assert ("log_cql_alpha" in tts.optim) == kw["with_lagrange"] == hasattr(tts.model, "log_cql_alpha")
        assert ("log_alpha" in tts.optim) == (kw.get("alpha", "auto") == "auto")


def test_cql_preprocess_is_the_one_step_target(rings):
    """CQL's returns: ``rew + gamma * (1 - terminated) * (min Q' - alpha * logp)`` of SAC's next action,
    also at rows whose chain would continue (no n-step)."""
    jb, js, tb, ts, idx = rings[2]
    jalgo, jts, talgo, tts = _pair("cql", 2)
    key = jax.random.key(5)
    jbatch = jalgo.preprocess(jts, jb, js, jb.get(js, jnp.asarray(idx)), jnp.asarray(idx), key)
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, _t(idx)), _t(idx),
                              Draws(target=_t(jax.random.normal(key, (B, 2)))))
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)


TRAJECTORY_UPDATES = 40


@pytest.mark.parametrize("kind", ["td3bc", "cql"])
def test_many_updates_track_jax(rings, kind):
    """``TRAJECTORY_UPDATES`` updates in a row, each with fresh rows and the JAX key's own draws: the losses
    step by step and the train state at the end stay with the JAX package's (CQL with its Lagrange multiplier
    and the entropy alpha). Tolerances: losses rtol 1e-4 / atol 1e-5 and every weight, target and multiplier
    within 2e-4 at the end, wider than one update's because Adam divides each step by the root of a small
    second moment and so carries float32 rounding forward; a fault in a step's arithmetic, its optimizer state
    or its order moves them by far more (a trajectory of 300 CQL updates drifts 3e-3 at most)."""
    jb, js, tb, ts, _ = rings[1]
    jalgo, jts, talgo, tts = _pair(kind, 1)
    rng = np.random.default_rng(11)
    pre = jax.jit(lambda t, s, b, i, k: jalgo.preprocess(t, jb, s, b, i, k))
    upd = jax.jit(jalgo.update_step)
    for step in range(TRAJECTORY_UPDATES):
        idx = rng.integers(0, E * 13, B)
        key = jax.random.key(100 + step)
        _, k2, k3 = jax.random.split(key, 3)
        jidx = jnp.asarray(idx)
        jts, jstats = upd(jts, pre(jts, js, jb.get(js, jidx), jidx, k2), k3)
        tstats = talgo.update(tts, tb, ts, _draws(kind, key, 1, idx), B)[2]
        np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), rtol=1e-4, atol=1e-5, err_msg=str(step))
    assert int(tts.step) == int(jts.step) == TRAJECTORY_UPDATES
    got, want = _state(tts), _jax_state(jts, tts)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("act_dim", [1, 2])
def test_bc_continuous_update_and_acting_match_jax(rings, act_dim):
    jb, js, tb, ts, idx = rings[act_dim]
    jnet = jcont.ContinuousActorDeterministic(HID, act_dim, max_action=2.0)
    jalgo = JBC(model=jnet, action_space=jcore.Box(-2.0, 2.0, (act_dim,)), optim=JAdam(lr=1e-3),
                action_bound_method=None)
    talgo = ImitationLearning(model=continuous.ContinuousActorDeterministic(HID, act_dim, 2.0, input_dim=OBS),
                              action_space=tcore.Box(-2.0, 2.0, (act_dim,)), optim=AdamOptimizerFactory(lr=1e-3),
                              action_bound_method=None)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(continuous_actor_det_params_from_flax(_np(jts.params["model"])))
    obs = np.random.default_rng(6).standard_normal((7, OBS)).astype(np.float32)
    jact = jalgo.forward(jts, jnp.asarray(obs), jax.random.key(0)).act
    np.testing.assert_allclose(talgo.forward(tts, _t(obs)).act.numpy(), np.asarray(jact), **TOL)
    np.testing.assert_allclose(talgo.map_action(_t(np.asarray(jact) * 3)).numpy(),
                               np.asarray(jalgo.map_action(jact * 3)), **TOL)  # no clip, no scaling
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jb.get(js, jnp.asarray(idx)), jax.random.key(1))
    _, _, tstats = talgo.update(tts, tb, ts, Draws(indices=_t(idx).long()), B)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
    _hold(tts.model.state_dict(), continuous_actor_det_params_from_flax(_np(jts2.params["model"])))


# ---------------------------------------------------------------------------
# BCQ's nets and acting
# ---------------------------------------------------------------------------
def test_perturbation_matches_jax():
    rng = np.random.default_rng(7)
    obs, act = rng.standard_normal((9, OBS)).astype(np.float32), rng.uniform(-1, 1, (9, 2)).astype(np.float32)
    act[0] = 0.999  # the clip at max_action
    m = jcont.Perturbation(HID, 2, max_action=1.0, phi=0.5)
    p = m.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(act))
    net = continuous.Perturbation(HID, 2, max_action=1.0, phi=0.5, input_dim=OBS)
    net.load_state_dict(perturbation_params_from_flax(_np(p)))
    with torch.no_grad():
        got = net(_t(obs), _t(act))
    want = np.asarray(m.apply(p, jnp.asarray(obs), jnp.asarray(act)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got.abs().max()) <= 1.0 and (np.abs(want) == 1.0).any()


def test_vae_forward_and_decode_match_jax():
    """The forward with the key's normals handed over, ``decode`` with a handed ``z``, and ``decode``
    without one (the key's normals through ``VAE.latent``)."""
    rng = np.random.default_rng(8)
    obs, act = rng.standard_normal((6, OBS)).astype(np.float32), rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    z = (rng.standard_normal((6, LATENT)) * 2).astype(np.float32)
    m = jcont.VAE((16,), (16, 8), 2, LATENT, max_action=1.5)
    p = m.init({"params": jax.random.key(2)}, jnp.asarray(obs), jnp.asarray(act), jax.random.key(3))
    net = continuous.VAE((16,), (16, 8), 2, LATENT, max_action=1.5, input_dim=OBS)
    net.load_state_dict(vae_params_from_flax(_np(p)))
    key = jax.random.key(4)
    want = [np.asarray(x) for x in m.apply(p, jnp.asarray(obs), jnp.asarray(act), key)]
    with torch.no_grad():
        got = net(_t(obs), _t(act), _t(jax.random.normal(key, (6, LATENT))))
        decoded = net.decode(_t(obs), _t(z))
        sampled = net.decode(_t(obs), net.latent(_t(jax.random.normal(key, (6, LATENT)))))
        drawn = net.decode(_t(obs), generator=torch.Generator().manual_seed(0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(m.apply(p, jnp.asarray(obs), jnp.asarray(z),
                                                                   method="decode")), **TOL)
    np.testing.assert_allclose(sampled.numpy(), np.asarray(m.apply(p, jnp.asarray(obs), key=key, method="decode")),
                               **TOL)
    with torch.no_grad():  # the generator route draws the normals that decode's latent takes
        again = net.decode(_t(obs), net.latent(torch.randn((6, LATENT), generator=torch.Generator().manual_seed(0))))
    assert torch.equal(drawn, again) and float(drawn.abs().max()) <= 1.5


def test_bcq_acting_matches_jax():
    """``forward_sampled_times`` perturbed candidates per row, the first critic's best, from the key's
    normals; the map to the env's bounds (scaling by 2)."""
    jalgo, jts, talgo, tts = _pair("bcq", 2)
    obs = np.random.default_rng(9).standard_normal((5, OBS)).astype(np.float32)
    key = jax.random.key(6)
    jout = jalgo.forward(jts, jnp.asarray(obs), key)
    tout = talgo.forward(tts, _t(obs), Draws(decode=_t(jax.random.normal(key, (5 * N_DEC, LATENT)))))
    np.testing.assert_allclose(tout.act.numpy(), np.asarray(jout.act), **TOL)
    np.testing.assert_allclose(talgo.map_action(tout.act).numpy(), np.asarray(jalgo.map_action(jout.act)), **TOL)
    assert talgo.exploration_noise(tts, tout.act, _t(obs), torch.Generator()) is tout.act
