"""The port's on-policy family (``OnPolicyActorCritic``, ``PPO``, ``A2C``,
``Reinforce``) and its learning-rate schedule against the JAX package.

Both sides get the same numpy rollout (``[T=8, E=4]``, HalfCheetah-shaped:
17-wide observations, 6-wide actions, terminations and truncations; or
CartPole-shaped with 2 discrete actions) and the same weights (flax's,
carried over by ``actor_critic_params_from_flax``).

- ``process_rollout`` with and without return standardization (and without
  a critic): ``v_s``, ``adv``, ``returns``, ``unnorm_returns``, ``logp_old``
  and ``dist_old`` at atol 1e-5; the running return statistics after
  ``update_return_stats`` at rtol 1e-5. The return-scaling contract of
  ``tests/test_onpolicy.py:90-150`` (no mean subtraction, returns in
  running-std space, the parallel Welford merge).
- ``loss_minibatch`` and its gradients for PPO (plain, ``dual_clip``,
  ``value_clip``, discrete), A2C and Reinforce at atol 1e-5.
- A whole ``update_rollout`` with JAX's permutations handed over (drawn
  from the JAX key as its update draws them): every weight and both Adam
  moments after the update within 1e-4 of JAX's and 99.9% of each tensor
  within 2e-6 (the tolerance of ``tests/test_torch_rainbow.py``'s one Adam
  step), the step counters equal, the averaged stats at atol 1e-4. Cases:
  PPO with advantage normalization, with return standardization and value
  clip, with ``recompute_advantage``, with ``target_kl`` tripping mid-way;
  A2C; Reinforce.
- The KL guard: an update that trips from its first minibatch leaves the
  parameters, Adam's state, the learning rate and ``ts.step`` bit-identical;
  one that trips mid-way leaves the state bit-identical to the same updates
  cut at the last untripped minibatch.
- ``linear_lr_schedule`` against ``optax.linear_schedule`` over six steps
  (rates and weights after six Adam steps), ``map_action`` and
  ``map_action_inverse`` against JAX, and the minibatch index draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.a2c import A2C as JA2C
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.modelfree.reinforce import Reinforce as JReinforce
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.modelfree.reinforce import Reinforce
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, linear_lr_schedule
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import continuous, discrete
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

T, E, OBS, A = 8, 4, 17, 6
N = T * E
TOL = dict(rtol=0, atol=1e-5)
ALGOS = {"ppo": (JPPO, PPO), "a2c": (JA2C, A2C), "reinforce": (JReinforce, Reinforce)}


def t(x):
    return torch.from_numpy(np.array(x))


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def make_pair(kind="ppo", discrete_act=False, lr=1e-3, **kw):
    """(JAX algo, JAX train state, port algo, port train state) with the same weights."""
    jcls, tcls = ALGOS[kind]
    obs_dim = 4 if discrete_act else OBS
    if discrete_act:
        j_actor, j_critic = jdisc.DiscreteActor((16, 16), 2), jdisc.DiscreteCritic((16, 16))
        t_actor = discrete.DiscreteActor((16, 16), 2, input_dim=obs_dim)
        t_critic = discrete.DiscreteCritic((16, 16), input_dim=obs_dim)
        j_space, t_space = jcore.Discrete(2), tcore.Discrete(2)
    else:
        j_actor = jcont.ContinuousActorProbabilistic((16, 16), A)
        j_critic = jcont.ContinuousCritic((16, 16), use_action=False)
        t_actor = continuous.ContinuousActorProbabilistic((16, 16), A, input_dim=obs_dim)
        t_critic = continuous.ContinuousCritic((16, 16), use_action=False, input_dim=obs_dim)
        j_space, t_space = jcore.Box(-1.0, 1.0, (A,)), tcore.Box(-1.0, 1.0, (A,))
    j_args = dict(actor=j_actor, action_space=j_space, optim=JAdam(lr=lr, max_grad_norm=0.5), **kw)
    t_args = dict(actor=t_actor, action_space=t_space, optim=AdamOptimizerFactory(lr=lr, max_grad_norm=0.5), **kw)
    if kind != "reinforce":  # REINFORCE has no critic
        j_args["critic"], t_args["critic"] = j_critic, t_critic
    jalgo, talgo = jcls(**j_args), tcls(**t_args)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(obs_dim))
    params = npy(jts.params)
    if not discrete_act:  # a sigma other than 1
        params["actor"]["params"]["log_sigma"] = np.linspace(-0.6, 0.3, A).astype(np.float32)
        jts = jts.replace(params=jax.tree.map(jnp.asarray, params))
    if "ret_var" in jts.extra:  # running statistics away from their start
        extra = jts.extra.copy()
        extra.ret_mean, extra.ret_var, extra.ret_count = jnp.float32(0.3), jnp.float32(2.5), jnp.float32(40.0)
        jts = jts.replace(extra=extra)
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(params, tts.model))
    for k in tts.extra:
        tts.extra[k].fill_(float(jts.extra[k]))
    return jalgo, jts, talgo, tts


def make_rollout(discrete_act=False, seed=0):
    """A numpy rollout ``[T, E]`` as (JAX Batch, port Batch)."""
    rng = np.random.default_rng(seed)
    obs_dim = 4 if discrete_act else OBS
    term = rng.random((T, E)) < 0.1
    d = dict(
        obs=rng.normal(0, 1, (T, E, obs_dim)).astype(np.float32),
        obs_next=rng.normal(0, 1, (T, E, obs_dim)).astype(np.float32),
        act=(rng.integers(0, 2, (T, E)) if discrete_act else rng.normal(0, 0.8, (T, E, A)).astype(np.float32)),
        rew=rng.normal(0.5, 1, (T, E)).astype(np.float32),
        terminated=term,
        truncated=(rng.random((T, E)) < 0.1) & ~term,
    )
    return JBatch(**{k: jnp.asarray(v) for k, v in d.items()}), Batch(**{k: t(v) for k, v in d.items()})


def jax_perms(key, repeat, batch_size, recompute=False):
    """The minibatch indices the JAX ``update_rollout`` draws from ``key``,
    ``[repeat, n_mb, mb_size]``."""
    n_mb = max(1, N // batch_size)
    mb = N // n_mb

    def perm(rkey):
        k_perm, _ = jax.random.split(rkey)
        return np.asarray(jax.random.permutation(k_perm, N))[: n_mb * mb].reshape(n_mb, mb)

    if recompute:
        key, _ = jax.random.split(key)
        out = []
        for _ in range(repeat):
            key, _, k_loop = jax.random.split(key, 3)
            out.append(perm(jax.random.split(k_loop, 1)[0]))
        return t(np.stack(out)).long()
    _, k_loop = jax.random.split(key)
    return t(np.stack([perm(rk) for rk in jax.random.split(k_loop, repeat)])).long()


def to_port(jb):
    """A JAX Batch as a port Batch of CPU tensors."""
    return Batch({k: to_port(v) if isinstance(v, JBatch) else t(v) for k, v in jb.items()})


def by_name(model, tensors):
    """``{state_dict key: tensor}`` for per-parameter tensors listed in parameter order."""
    return dict(zip((k for k, _ in model.named_parameters()), tensors))


def assert_weights_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-4, err_msg=k)
        assert np.mean(np.abs(g - w.numpy()) <= 2e-6) >= 0.999, k


def adam_states(jts):
    """The optax Adam state of a JAX train state (``clip_by_global_norm`` then ``adam``)."""
    return next(s for s in jax.tree.leaves(jts.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ret_std", [False, True])
@pytest.mark.parametrize("kind", ["ppo", "reinforce"])
def test_process_rollout_matches_jax(kind, ret_std):
    jalgo, jts, talgo, tts = make_pair(kind, return_standardization=ret_std)
    jroll, troll = make_rollout()
    jb = jalgo.process_rollout(jts, jroll, jax.random.key(1))
    tb = talgo.process_rollout(tts, troll)
    keys = ["adv", "returns", "logp_old"] + (["v_s"] if kind == "ppo" else []) + (["unnorm_returns"] if ret_std else [])
    assert set(tb.keys()) == set(jb.keys())
    for k in keys:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), **TOL, err_msg=k)
    for k in ("loc", "scale"):
        np.testing.assert_allclose(tb.dist_old[k].numpy(), np.asarray(jb.dist_old[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(tb.obs.numpy(), np.asarray(jb.obs))
    if ret_std:
        jts2 = jalgo.update_return_stats(jts, jb)
        talgo.update_return_stats(tts, tb)
        assert "unnorm_returns" not in tb
        for k in ("ret_mean", "ret_var", "ret_count"):
            np.testing.assert_allclose(float(tts.extra[k]), float(jts2.extra[k]), rtol=1e-5, err_msg=k)


def test_process_rollout_discrete_matches_jax():
    jalgo, jts, talgo, tts = make_pair("ppo", discrete_act=True)
    jroll, troll = make_rollout(discrete_act=True)
    jb = jalgo.process_rollout(jts, jroll, jax.random.key(1))
    tb = talgo.process_rollout(tts, troll)
    for k in ("v_s", "adv", "returns", "logp_old"):
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(tb.dist_old.logits.numpy(), np.asarray(jb.dist_old.logits), **TOL)


def test_return_scaling_reference_semantics():
    """``tests/test_onpolicy.py:90-150`` on the port: the critic learns in
    running-std space (no mean subtraction), GAE runs on un-scaled values,
    and the running variance merges by parallel Welford."""
    _, _, algo, ts = make_pair("ppo", return_standardization=True, gamma=0.9, gae_lambda=1.0)
    ts.extra["ret_mean"].fill_(0.0)
    ts.extra["ret_var"].fill_(4.0)
    ts.extra["ret_count"].fill_(100.0)
    rollout = Batch(obs=torch.zeros(4, 2, OBS), obs_next=torch.zeros(4, 2, OBS), act=torch.zeros(4, 2, A),
                    rew=torch.ones(4, 2), terminated=torch.zeros(4, 2, dtype=torch.bool),
                    truncated=torch.zeros(4, 2, dtype=torch.bool))
    batch = algo.process_rollout(ts, rollout)
    scale = float(torch.sqrt(ts.extra["ret_var"] + 1e-8))
    with torch.no_grad():
        v0 = float(ts.model["critic"](torch.zeros(1, OBS))[0])
    np.testing.assert_allclose(batch.returns.numpy() * scale, batch.adv.numpy() + v0 * scale, rtol=1e-5)
    assert float(batch.returns.mean()) > 0.0
    assert "unnorm_returns" in batch
    x = batch.unnorm_returns.numpy()
    algo.update_return_stats(ts, batch)
    assert "unnorm_returns" not in batch
    c0, m0, v0r = 100.0, 0.0, 4.0
    tot = c0 + x.size
    exp_mean = (m0 * c0 + x.sum()) / tot
    exp_var = (v0r * c0 + x.var() * x.size + (x.mean() - m0) ** 2 * c0 * x.size / tot) / tot
    np.testing.assert_allclose(float(ts.extra["ret_mean"]), exp_mean, rtol=1e-5)
    np.testing.assert_allclose(float(ts.extra["ret_var"]), exp_var, rtol=1e-4)


# ---------------------------------------------------------------------------
LOSS_CASES = [
    ("ppo", False, {}),
    ("ppo", False, {"dual_clip": 3.0}),
    ("ppo", False, {"value_clip": True, "return_standardization": True}),
    ("ppo", True, {"ent_coef": 0.01}),
    ("a2c", False, {}),
    ("reinforce", False, {}),
]


@pytest.mark.parametrize("kind,discrete_act,kw", LOSS_CASES,
                         ids=["ppo", "ppo_dual_clip", "ppo_value_clip", "ppo_discrete", "a2c", "reinforce"])
def test_loss_and_gradients_match_jax(kind, discrete_act, kw):
    jalgo, jts, talgo, tts = make_pair(kind, discrete_act, **kw)
    jroll, _ = make_rollout(discrete_act)
    jb = jalgo.process_rollout(jts, jroll, jax.random.key(1))
    jb.pop("unnorm_returns", None)
    # move the policy off the rollout's so that the ratio clips somewhere
    shift = jax.tree.map(lambda x: x * 0.5, jts.params)
    jparams = jax.tree.map(lambda a, b: a + b * np.float32(0.6), jts.params, shift)
    tts.model.load_state_dict(actor_critic_params_from_flax(npy(jparams), tts.model))
    tb = to_port(jb)
    (jloss, jstats), jgrads = jax.value_and_grad(jalgo.loss_minibatch, has_aux=True)(jparams, jb, jax.random.key(2))
    loss, stats = talgo.loss_minibatch(tts.model, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    want = actor_critic_params_from_flax(npy(jgrads), tts.model)
    for name, p in tts.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL, err_msg=name)


# ---------------------------------------------------------------------------
UPDATE_CASES = [
    ("ppo", False, {}, 2, 16),
    ("ppo", False, {"value_clip": True, "return_standardization": True, "advantage_normalization": False}, 2, 16),
    ("ppo", False, {"recompute_advantage": True, "return_standardization": True, "value_clip": True}, 3, 8),
    ("ppo", False, {"target_kl": 0.003}, 3, 8),
    ("ppo", True, {"ent_coef": 0.01}, 2, 16),
    ("a2c", False, {"return_standardization": True}, 1, 32),
    ("reinforce", False, {}, 2, 16),
]


@pytest.mark.parametrize("kind,discrete_act,kw,repeat,batch_size", UPDATE_CASES,
                         ids=["ppo", "ppo_ret_std_value_clip", "ppo_recompute", "ppo_target_kl", "ppo_discrete",
                              "a2c", "reinforce"])
def test_update_rollout_matches_jax(kind, discrete_act, kw, repeat, batch_size):
    jalgo, jts, talgo, tts = make_pair(kind, discrete_act, lr=1e-2 if "target_kl" in kw else 1e-3, **kw)
    jroll, troll = make_rollout(discrete_act)
    key = jax.random.key(5)
    jts2, jstats = jalgo.update_rollout(jts, jroll, key, repeat=repeat, batch_size=batch_size)
    perm = jax_perms(key, repeat, batch_size, recompute=kw.get("recompute_advantage", False))
    _, stats = talgo.update_rollout(tts, troll, None, repeat, batch_size, perm=perm)
    model = tts.model
    assert_weights_close(model.state_dict(), actor_critic_params_from_flax(npy(jts2.params), model))
    adam = adam_states(jts2)
    params = list(model.parameters())
    for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = by_name(model, [tts.optim.state[p][ours] for p in params])
        assert_weights_close(got, actor_critic_params_from_flax(npy(theirs), model))
    assert int(tts.step) == int(jts2.step) == int(tts.optim.state[params[0]]["step"]) == int(adam.count)
    for k in tts.extra:
        np.testing.assert_allclose(float(tts.extra[k]), float(jts2.extra[k]), rtol=1e-5, err_msg=k)
    jstats = dict(jstats.items())
    if kw.get("recompute_advantage"):  # the JAX package counts the last pass only
        assert int(jstats.pop("n_grad_steps")) == perm.shape[1]
        assert int(stats.pop("n_grad_steps")) == repeat * perm.shape[1]
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    if "target_kl" in kw:  # the guard tripped mid-way on both sides
        assert 0.0 < float(stats.kl_stop) < 1.0
        assert int(tts.step) < repeat * perm.shape[1]


def _state(ts):
    params = list(ts.model.parameters())
    opt = [v.clone() for p in params for v in ts.optim.state[p].values()]
    return [p.detach().clone() for p in params] + opt + [ts.step.clone(), torch.as_tensor(ts.optim.param_groups[0]["lr"])]


def test_kl_guard_tripping_at_once_leaves_the_state_bit_identical():
    _, _, algo, ts = make_pair("ppo", target_kl=-1.0, lr=linear_lr_schedule(1e-3, 100))
    _, roll = make_rollout()
    algo.update_rollout(ts, roll, None, 1, 8, perm=torch.arange(N).reshape(1, 4, 8))  # a first update moves the state
    before = _state(ts)
    _, stats = algo.update_rollout(ts, roll, torch.Generator().manual_seed(0), 3, 8)
    assert float(stats.kl_stop) == 1.0 and int(stats.n_grad_steps) == 12
    for a, b in zip(_state(ts), before):
        assert torch.equal(a, b)


def test_kl_guard_mid_way_equals_the_updates_cut_at_the_trip():
    """Tripped at minibatch k, the state is bit-identical to k untripped updates."""
    sides = {}
    perm = torch.stack([torch.randperm(N, generator=torch.Generator().manual_seed(r)) for r in range(3)]).reshape(3, 4, 8)
    for guarded in (True, False):
        _, _, algo, ts = make_pair("ppo", target_kl=0.003 if guarded else None, lr=1e-2)
        _, roll = make_rollout()
        if guarded:
            _, stats = algo.update_rollout(ts, roll, None, 3, 8, perm=perm)
            kept = round(12 * (1 - float(stats.kl_stop)))
            assert 0 < kept < 12
        else:
            flat = perm.reshape(12, 8)[:kept].reshape(1, kept, 8)
            algo.update_rollout(ts, roll, None, 1, 8, perm=flat)
        sides[guarded] = _state(ts)
    assert int(sides[True][-2]) == kept
    for a, b in zip(sides[True][:-1], sides[False][:-1]):
        assert torch.equal(a, b)


def test_minibatch_indices_are_permutations():
    algo = make_pair("ppo")[2]
    assert algo.minibatch_shape(33, 8) == (4, 8) and algo.minibatch_shape(5, 64) == (1, 5)
    idx = algo.minibatch_indices(33, 3, 8, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert idx.shape == (3, 4, 8) and idx.dtype == torch.int64
    for r in range(3):
        assert len(set(idx[r].flatten().tolist())) == 32 and int(idx[r].max()) < 33
    assert not torch.equal(idx[0], idx[1])


# ---------------------------------------------------------------------------
def test_linear_schedule_matches_optax():
    """Six Adam steps under ``linear_lr_schedule(0.1, 4)`` (the rate reaches
    zero at the fourth update and stays there) against optax's."""
    sched, jsched = linear_lr_schedule(0.1, 4), optax.linear_schedule(0.1, 0.0, 4)
    for count in range(6):
        assert float(sched(torch.tensor(float(count)))) == float(jsched(jnp.int32(count)))
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 1, (5, 3)).astype(np.float32)
    grads = rng.normal(0, 1, (6, 5, 3)).astype(np.float32)
    tx = optax.adam(jsched)
    w, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(t(w0))
    factory = AdamOptimizerFactory(lr=sched)
    opt = factory.create([p])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
        p.grad = t(g)
        factory.step(opt)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=2e-6)
    assert int(opt.state[p]["step"]) == 6 and float(opt.param_groups[0]["lr"]) == 0.0


@pytest.mark.parametrize("method", ["clip", "tanh", None])
@pytest.mark.parametrize("scaling", [True, False])
def test_map_action_matches_jax(method, scaling):
    low, high = [-2.0, 0.0, -1.0], [2.0, 3.0, 0.5]
    jalgo = JPPO(actor=None, critic=None, action_space=jcore.Box(low, high), action_scaling=scaling,
                 action_bound_method=method)
    talgo = PPO(actor=None, critic=None, action_space=tcore.Box(low, high), action_scaling=scaling,
                action_bound_method=method)
    act = np.random.default_rng(0).normal(0, 1.5, (8, 3)).astype(np.float32)
    mapped = np.asarray(jalgo.map_action(jnp.asarray(act)))
    np.testing.assert_allclose(talgo.map_action(t(act)).numpy(), mapped, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(talgo.map_action_inverse(t(mapped)).numpy(),
                               np.asarray(jalgo.map_action_inverse(jnp.asarray(mapped))), rtol=1e-5, atol=1e-5)
    disc = PPO(actor=None, critic=None, action_space=tcore.Discrete(3))
    assert disc.map_action(torch.tensor([0, 2])).tolist() == [0, 2] and not disc.action_scaling
