"""The port's NPG and TRPO (``tianshou_tpu_torch/algorithm/modelfree/{npg,trpo}.py``)
against the JAX package, on the CPU.

Both sides get the same weights (flax's, carried over by
``actor_critic_params_from_flax``) and the numpy rollout of
``tests/test_torch_onpolicy.py`` (``[T=8, E=4]``, HalfCheetah-shaped, or
CartPole-shaped with 2 discrete actions).

- ``conjugate_gradient`` on a fixed 12x12 SPD system: within 1e-6 of JAX's
  and of the exact solution's 10-iteration value.
- The damped Fisher-vector product (the port's double backward against
  JAX's ``jvp`` of ``grad``) for a ``Normal`` and a ``Categorical`` actor,
  at the rollout's policy and at a moved one: relative error 1e-5 of the
  product's largest entry (measured 2e-7).
- ``_natural_step``: the objective within 1e-6, the direction ``s`` within
  1e-3 of its largest entry and ``sHs`` within rtol 1e-3. Ten conjugate
  gradient iterations magnify float32 reassociation: the products agree to
  2e-7, the directions to 1.3e-4 of their largest entry (measured).
- A whole ``update_rollout`` of NPG (``trust_region_size`` 0.5, 3 critic
  steps) and of TRPO (``max_kl`` 0.01), with JAX's minibatch indices handed
  over: the critic and both Adam moments by the rule of
  ``tests/test_torch_onpolicy.py`` (1e-4, 99.9% within 2e-6), the Adam count
  and the step counter equal, the actor within 1e-3 (NPG, the second
  minibatch's step starts from the first's rounding) and 1e-4 (TRPO),
  the stats at 1e-3, and TRPO's ``step_frac`` and ``accepted`` exactly. The
  rollout is far from the KL bound: every update takes a fraction of at
  least 0.8 ** 2 with a KL well below ``max_kl``.
- TRPO with every candidate rejected (``max_kl`` 1e4: each fraction's step
  leaves the KL bound): ``step_frac`` 0 and ``accepted`` 0 on both sides and
  the actor bit-unchanged.
- NPG's critic steps leave the actor bit-unchanged, move the actor's Adam
  moments as optax does (decayed by the zero gradients) and the critic's
  within the Adam rule.
- ``OnPolicyTrainer`` logs NPG's and TRPO's stats with the JAX trainer's
  keys and writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from tests.test_torch_onpolicy import (A, OBS, adam_states, assert_weights_close, by_name, jax_perms, make_rollout,
                                       npy, t, to_port)
from tests.test_torch_onpolicy_trainer import E_TEST, E_TRAIN, keys_of, recorder
from tests.helpers import make_collectors
from tianshou_tpu.algorithm.modelfree.npg import NPG as JNPG
from tianshou_tpu.algorithm.modelfree.npg import conjugate_gradient as jconjugate_gradient
from tianshou_tpu.algorithm.modelfree.trpo import TRPO as JTRPO
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env.classic.cartpole import CartPole as JCartPole
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu.trainer.trainer import OnPolicyTrainer as JTrainer
from tianshou_tpu.trainer.trainer import OnPolicyTrainerParams as JParams
from tianshou_tpu.utils.logger.base import BaseLogger as JBaseLogger
from tianshou_tpu_torch.algorithm.modelfree.npg import NPG, _flat, conjugate_gradient
from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models import continuous, discrete
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
from tianshou_tpu_torch.utils.logger.base import BaseLogger
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ALGOS = {"npg": (JNPG, NPG), "trpo": (JTRPO, TRPO)}


def make_pair(kind="npg", discrete_act=False, **kw):
    """(JAX algo, JAX train state, port algo, port train state) with the same weights."""
    jcls, tcls = ALGOS[kind]
    obs_dim = 4 if discrete_act else OBS
    if discrete_act:
        j_actor, t_actor = jdisc.DiscreteActor((16, 16), 2), discrete.DiscreteActor((16, 16), 2, input_dim=obs_dim)
        j_space, t_space = jcore.Discrete(2), tcore.Discrete(2)
    else:
        j_actor = jcont.ContinuousActorProbabilistic((16, 16), A)
        t_actor = continuous.ContinuousActorProbabilistic((16, 16), A, input_dim=obs_dim)
        j_space, t_space = jcore.Box(-1.0, 1.0, (A,)), tcore.Box(-1.0, 1.0, (A,))
    kw.setdefault("optim_critic_iters", 3)
    jalgo = jcls(actor=j_actor, critic=jcont.ContinuousCritic((16, 16), use_action=False), action_space=j_space,
                 optim=JAdam(lr=1e-3), **kw)
    talgo = tcls(actor=t_actor, critic=continuous.ContinuousCritic((16, 16), use_action=False, input_dim=obs_dim),
                 action_space=t_space, optim=AdamOptimizerFactory(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(obs_dim))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(npy(jts.params), tts.model))
    return jalgo, jts, talgo, tts


def processed(jalgo, jts, discrete_act=False):
    """The JAX package's processed minibatch of the whole rollout (advantages
    normalized as a minibatch is), as (JAX Batch, port Batch)."""
    jroll, _ = make_rollout(discrete_act)
    jb = jalgo.process_rollout(jts, jroll, jax.random.key(1))
    jb.pop("unnorm_returns", None)
    jb.adv = (jb.adv - jb.adv.mean()) / (jb.adv.std() + 1e-8)
    return jb, to_port(jb)


def moved(jts, scale):
    """JAX params with the actor scaled by ``1 + scale`` (a policy off the rollout's)."""
    return {**jts.params, "actor": jax.tree.map(lambda x: x * np.float32(1 + scale), jts.params["actor"])}


def port_flat(tts, tree):
    """A JAX actor tree (the actor's shape) as the port's flat vector, in its parameter order."""
    sd = actor_critic_params_from_flax({"actor": npy(tree), "critic": npy(jax.tree.map(jnp.zeros_like, tree))},
                                       torch.nn.ModuleDict({"actor": tts.model["actor"]}))
    return _flat(sd[f"actor.{n}"] for n, _ in tts.model["actor"].named_parameters())


# ---------------------------------------------------------------------------
def test_conjugate_gradient_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(12, 12)).astype(np.float32)
    a = (m @ m.T / 12 + np.eye(12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jconjugate_gradient(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), 10))
    got = conjugate_gradient(lambda v: t(a) @ v, t(b), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(a.astype(np.float64), b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("discrete_act", [False, True], ids=["normal", "categorical"])
@pytest.mark.parametrize("scale", [0.0, 0.05], ids=["at_rollout", "moved"])
def test_fisher_vector_product_matches_jax(discrete_act, scale):
    jalgo, jts, talgo, tts = make_pair("npg", discrete_act)
    jb, tb = processed(jalgo, jts, discrete_act)
    params = moved(jts, scale)
    tts.model.load_state_dict(actor_critic_params_from_flax(npy(params), tts.model))
    flat_pa, unravel = ravel_pytree(params["actor"])
    v = np.random.default_rng(1).normal(size=flat_pa.shape).astype(np.float32)
    hv = jax.jvp(jax.grad(lambda fp: jalgo._kl_to_old(unravel(fp), jb)), (flat_pa,), (jnp.asarray(v),))[1]
    want = port_flat(tts, unravel(hv + jalgo.damping * jnp.asarray(v)))
    actor = tts.model["actor"]
    ps = list(actor.parameters())
    grad_kl = _flat(torch.autograd.grad(talgo._kl_to_old(actor, tb), ps, create_graph=True))
    vt = port_flat(tts, unravel(jnp.asarray(v)))
    got = _flat(torch.autograd.grad(grad_kl @ vt, ps)) + talgo.damping * vt
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("discrete_act", [False, True], ids=["normal", "categorical"])
def test_natural_step_matches_jax(discrete_act):
    jalgo, jts, talgo, tts = make_pair("npg", discrete_act)
    jb, tb = processed(jalgo, jts, discrete_act)
    for scale in (0.0, 0.05):
        params = moved(jts, scale)
        tts.model.load_state_dict(actor_critic_params_from_flax(npy(params), tts.model))
        s_tree, obj, shs = jalgo._natural_step(params["actor"], jb)
        s, tobj, tshs = talgo._natural_step(tts.model["actor"], tb)
        want = port_flat(tts, s_tree)
        np.testing.assert_allclose(float(tobj), float(obj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), want.numpy(), rtol=0, atol=1e-3 * float(want.abs().max()))
        np.testing.assert_allclose(float(tshs), float(shs), rtol=1e-3)


# ---------------------------------------------------------------------------
UPDATE_CASES = [("npg", dict(trust_region_size=0.5), 1e-3), ("trpo", dict(max_kl=0.01), 1e-4)]


@pytest.mark.parametrize("kind,kw,actor_atol", UPDATE_CASES, ids=["npg", "trpo"])
def test_update_rollout_matches_jax(kind, kw, actor_atol):
    jalgo, jts, talgo, tts = make_pair(kind, **kw)
    jroll, troll = make_rollout()
    key = jax.random.key(5)
    jts2, jstats = jalgo.update_rollout(jts, jroll, key, repeat=1, batch_size=16)
    perm = jax_perms(key, 1, 16)
    _, stats = talgo.update_rollout(tts, troll, None, 1, 16, perm=perm)
    model = tts.model
    want = actor_critic_params_from_flax(npy(jts2.params), model)
    got = model.state_dict()
    for k, w in want.items():
        if k.startswith("actor."):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=actor_atol, err_msg=k)
    assert_weights_close({k: v for k, v in got.items() if k.startswith("critic.")},
                         {k: v for k, v in want.items() if k.startswith("critic.")})
    adam = adam_states(jts2)
    params = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        assert_weights_close(by_name(model, [tts.optim.state[p][ours] for p in params]),
                             actor_critic_params_from_flax(npy(theirs), model))
    n_mb = perm.shape[1]
    assert int(tts.step) == int(jts2.step) == n_mb
    assert int(tts.optim.state[params[0]]["step"]) == int(adam.count) == n_mb * talgo.optim_critic_iters
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-3, atol=1e-3, err_msg=k)
    if kind == "trpo":
        for k in ("step_frac", "accepted"):
            assert float(stats[k]) == float(jstats[k]), k
        assert float(stats.step_frac) >= 0.8**2 and float(stats.accepted) == 1.0
        assert float(stats.kl) < 0.9 * talgo.max_kl


def test_trpo_rejecting_every_candidate_leaves_the_actor_bit_unchanged():
    jalgo, jts, talgo, tts = make_pair("trpo", max_kl=1e4)
    jb, tb = processed(jalgo, jts)
    jts2, jstats = jalgo._update_minibatch(jts, jb, jax.random.key(0))
    before = [p.detach().clone() for p in tts.model["actor"].parameters()]
    stats = talgo._update_minibatch(tts, tb)
    for k in ("step_frac", "accepted"):
        assert float(stats[k]) == float(jstats[k]) == 0.0, k
    for a, b in zip(tts.model["actor"].parameters(), before):
        assert torch.equal(a, b)
    assert jax.tree.all(jax.tree.map(lambda a, b: bool((a == b).all()), jts2.params["actor"], jts.params["actor"]))


def test_critic_steps_leave_the_actor_bit_unchanged():
    jalgo, jts, talgo, tts = make_pair("npg", optim_critic_iters=4)
    jb, tb = processed(jalgo, jts)
    jts2, jloss = jalgo._critic_steps(jts, jb)
    actor = [p.detach().clone() for p in tts.model["actor"].parameters()]
    loss = talgo._critic_steps(tts, tb)
    for a, b in zip(tts.model["actor"].parameters(), actor):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    model = tts.model
    assert_weights_close(model.state_dict(), actor_critic_params_from_flax(npy(jts2.params), model))
    adam = adam_states(jts2)
    params = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        assert_weights_close(by_name(model, [tts.optim.state[p][ours] for p in params]),
                             actor_critic_params_from_flax(npy(theirs), model))
    assert all(int(tts.optim.state[p]["step"]) == int(adam.count) == 4 for p in params)


# ---------------------------------------------------------------------------
TRAINER = dict(max_epochs=2, epoch_num_steps=2 * 32 * E_TRAIN, test_step_num_episodes=3, batch_size=64,
               collection_step_num_env_steps=32, update_step_num_repetitions=1, verbose=False)


@pytest.mark.parametrize("kind", ["npg", "trpo"])
def test_trainer_logs_the_stats_as_jax(kind):
    jcls, tcls = ALGOS[kind]
    logger = recorder(JBaseLogger)
    jalgo = jcls(actor=jdisc.DiscreteActor((16, 16), 2), critic=jdisc.DiscreteCritic((16, 16)),
                 action_space=JCartPole().action_space, optim=JAdam(lr=1e-3), deterministic_eval=True)
    train_c, test_c = make_collectors(JCartPole(), jalgo, None, n_train=E_TRAIN, n_test=E_TEST)
    jres = JTrainer(jalgo, train_c, test_c, JParams(**TRAINER, logger=logger)).run(
        jalgo.init(jax.random.key(0), jnp.zeros(4)), jax.random.key(1))
    jwrites = logger.writes
    torch.manual_seed(0)
    algo = tcls(actor=discrete.DiscreteActor((16, 16), 2, input_dim=4), critic=discrete.DiscreteCritic((16, 16), input_dim=4),
                action_space=CartPole().action_space, optim=AdamOptimizerFactory(lr=1e-3), deterministic_eval=True)
    logger = recorder(BaseLogger)
    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(CartPole(), E_TRAIN, device="cpu"), algo, None),
                              DeviceCollector(VectorDeviceEnv(CartPole(), E_TEST, device="cpu"), algo, None),
                              OnPolicyTrainerParams(**TRAINER, logger=logger))
    res = trainer.run(algo.init("cpu"), torch.Generator().manual_seed(1))
    assert keys_of(logger.writes) == keys_of(jwrites)
    assert (res.env_step, res.gradient_step, res.epochs) == (jres.env_step, jres.gradient_step, jres.epochs)
    update = [d for k, _, d in logger.writes if k == "update/gradient_step"]
    want = {"loss", "actor_objective", "vf_loss", "kl", "n_grad_steps"} | ({"step_frac", "accepted"} if kind == "trpo" else set())
    assert update and all(set(d) == {f"update/{k}" for k in want} for d in update)
    assert all(np.isfinite(v) for _, _, d in logger.writes for v in d.values())
