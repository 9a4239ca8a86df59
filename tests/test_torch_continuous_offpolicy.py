"""The port's continuous off-policy family (``DDPG``, ``TD3``, ``SAC``,
``REDQ``) against the JAX package.

Both packages get the same replay buffer (filled with the same numpy
transitions: 5-wide observations, 2-wide actions, terminations and
truncations over 4 env rings), the same weights (flax's, carried over by
``actor_critic_params_from_flax``, the targets moved away from the online
nets so that a test sees which net is read) and the JAX key's own draws: the
JAX update splits its key into k1 (the sample), k2 (the target's noise:
TD3's smoothing, SAC's and REDQ's next action, REDQ's subset from a second
split) and k3 (the actor's sample), and the port's ``update`` takes them as
``Draws``.

Tolerances:
- targets (``returns``), losses, TD errors, ``alpha`` and entropy: atol 1e-5;
- the train state after one update (every weight, target and Adam moment):
  all within 2e-5 and 99.9% of each tensor within 2e-6, the rule of
  ``tests/test_torch_dqn.py``; Adam's first step moves a weight by about
  lr = 1e-3 whatever its gradient, so the last bits of a near-zero gradient
  decide a few weights;
- at a delayed step (TD3 at an odd step, REDQ between multiples of
  ``actor_delay``) the actor, ``log_alpha`` and their Adam state are
  bit-identical to what they were;
- the sum tree after the priority writeback: rtol 1e-4 (``(|td| + eps) ** 0.6``
  of TD errors that agree to 1e-5);
- chains of four updates: the one-update rule after the chain (measured: every
  weight and Adam moment within 1.2e-7 of JAX's, for SAC and for TD3 + PER);
  the losses of each step at rtol 1e-4, atol 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.ddpg import DDPG as JDDPG
from tianshou_tpu.algorithm.modelfree.redq import REDQ as JREDQ
from tianshou_tpu.algorithm.modelfree.sac import SAC as JSAC
from tianshou_tpu.algorithm.modelfree.td3 import TD3 as JTD3
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.exploration.noise import GaussianNoise as JGaussianNoise
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu_torch.algorithm.base import Draws, optimizer_tensors
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.exploration.noise import GaussianNoise
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, A, HID, E, C, B, N, M = 5, 2, (16, 16), 4, 16, 12, 4, 2
TOL = dict(rtol=0, atol=1e-5)
ALGOS = {"ddpg": (JDDPG, DDPG), "td3": (JTD3, TD3), "sac": (JSAC, SAC), "redq": (JREDQ, REDQ)}


def t(x):
    return torch.from_numpy(np.array(x))


def npy(tree):
    return jax.tree.map(np.asarray, tree)


def make_pair(kind, n_step=1, **kw):
    """(JAX algo, JAX train state, port algo, port train state) with the same weights and targets."""
    jcls, tcls = ALGOS[kind]
    if kind in ("ddpg", "td3"):
        j_actor = jcont.ContinuousActorDeterministic(HID, A)
        t_actor = continuous.ContinuousActorDeterministic(HID, A, input_dim=OBS)
    else:
        j_actor = jcont.ContinuousActorProbabilistic(HID, A, conditioned_sigma=True)
        t_actor = continuous.ContinuousActorProbabilistic(HID, A, conditioned_sigma=True, input_dim=OBS)
    if kind == "redq":
        j_critic = jcont.EnsembleCritic(ensemble_size=N, hidden_sizes=HID)
        t_critic = continuous.EnsembleCritic(N, HID, input_dim=OBS, action_dim=A)
        kw = dict(ensemble_size=N, subset_size=M, **kw)
    else:
        j_critic, t_critic = jcont.ContinuousCritic(HID), continuous.ContinuousCritic(HID, input_dim=OBS, action_dim=A)
    common = dict(gamma=0.9, tau=0.05, n_step_return_horizon=n_step, **kw)
    jalgo = jcls(actor=j_actor, critic=j_critic, action_space=jcore.Box(-2.0, 2.0, (A,)),
                 policy_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=1e-3), **common)
    talgo = tcls(actor=t_actor, critic=t_critic, action_space=tcore.Box(-2.0, 2.0, (A,)),
                 policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3), **common)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    params = npy(jts.params)
    if "log_alpha" in params:
        params["log_alpha"] = np.float32(-0.7)  # alpha away from 1
    target = jax.tree.map(lambda x: (x * np.float32(0.8) + np.float32(0.01)).astype(np.float32), npy(jts.target_params))
    jts = jts.replace(params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(params, tts.model))
    tts.target.load_state_dict(actor_critic_params_from_flax(target, tts.target))
    return jalgo, jts, talgo, tts


def _example(jax_side):
    ex = dict(obs=np.zeros(OBS, np.float32), act=np.zeros(A, np.float32), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros(OBS, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def filled_buffers(prio=False, steps=13, seed=0):
    """Both packages' buffers with the same ``steps`` transitions per env (and, over prioritized
    replay, the same unequal priorities): (JAX buffer, state, port buffer, state)."""
    rng = np.random.default_rng(seed)
    if prio:
        jb, tb = JPVRB(E * C, E, alpha=0.6, beta=0.4), PrioritizedVectorReplayBuffer(E * C, E, alpha=0.6, beta=0.4)
    else:
        jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js, ts = jb.init(_example(True)), tb.init(_example(False), device="cpu")
    for _ in range(steps):
        term = rng.random(E) < 0.15
        step = dict(obs=rng.standard_normal((E, OBS)).astype(np.float32),
                    act=rng.uniform(-1.3, 1.3, (E, A)).astype(np.float32),  # raw actions, some beyond the clip
                    rew=rng.standard_normal(E).astype(np.float32), terminated=term,
                    truncated=(rng.random(E) < 0.1) & ~term, obs_next=rng.standard_normal((E, OBS)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    if prio:
        idx0 = rng.integers(0, E * C, 12)
        td0 = (rng.standard_normal(12) * 2).astype(np.float32)
        js = jb.update_weight(js, jnp.asarray(idx0), jnp.asarray(td0))
        tb.update_weight(ts, torch.from_numpy(idx0), torch.from_numpy(td0))
    return jb, js, tb, ts


def target_draws(kind, key, batch=B):
    """What the JAX ``preprocess`` draws from ``key`` (k2), as ``Draws``."""
    if kind == "redq":
        k1, k2 = jax.random.split(key)
        return Draws(target=t(jax.random.normal(k1, (batch, A))), subset=t(jax.random.permutation(k2, N)[:M]))
    return Draws(target=None if kind == "ddpg" else t(jax.random.normal(key, (batch, A))))


def update_draws(kind, key, jb, js):
    """Every draw of the JAX ``update`` from ``key``: the rows (k1), the target's noise (k2) and the
    actor's sample (k3)."""
    k1, k2, k3 = jax.random.split(key, 3)
    draws = target_draws(kind, k2)
    draws.indices = t(jb.sample_indices(js, k1, B)).long()
    if kind in ("sac", "redq"):
        draws.actor = t(jax.random.normal(k3, (B, A)))
    return draws


def port_state(ts) -> dict[str, torch.Tensor]:
    """Every weight of a port train state by name: ``model.*`` and ``target.*``."""
    out = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target.state_dict().items()})
    return out


def jax_state(jts, ts) -> dict[str, torch.Tensor]:
    out = {f"model.{k}": v for k, v in actor_critic_params_from_flax(npy(jts.params), ts.model).items()}
    out.update({f"target.{k}": v for k, v in actor_critic_params_from_flax(npy(jts.target_params), ts.target).items()})
    return out


def adam_moments(jts, ts) -> tuple[dict, dict]:
    """(JAX, port) Adam moments by name: ``{opt key}.{mu|nu}.{parameter}``."""
    want, got = {}, {}
    for key, opt in ts.optim.items():
        adam = next(s for s in jax.tree.leaves(jts.opt_state[key], is_leaf=lambda x: hasattr(x, "mu"))
                    if hasattr(s, "mu"))
        if key == "log_alpha":
            named = {"log_alpha": ts.model.log_alpha}
            conv = {m: {"log_alpha": t(getattr(adam, m))} for m in ("mu", "nu")}
        else:
            named = dict(ts.model[key].named_parameters())
            conv = {m: actor_critic_params_from_flax({key: npy(getattr(adam, m))},
                                                     torch.nn.ModuleDict({key: ts.model[key]})) for m in ("mu", "nu")}
            conv = {m: {k.split(".", 1)[1]: v for k, v in d.items()} for m, d in conv.items()}
        for m, tm in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for name, p in named.items():
                want[f"{key}.{m}.{name}"] = conv[m][name]
                got[f"{key}.{m}.{name}"] = opt.state[p][tm]
        assert int(adam.count) == int(opt.state[next(iter(named.values()))]["step"]), key
    return want, got


def assert_close_by_rule(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(g - w.numpy()) <= 2e-6) >= 0.999, k


# ---------------------------------------------------------------------------
# preprocess: n-step targets with the handed target noise
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def uniform():
    return filled_buffers(prio=False)


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("kind", ["ddpg", "td3", "sac", "redq"])
def test_preprocess_matches_jax(uniform, kind, n_step):
    jb, js, tb, ts = uniform
    jalgo, jts, talgo, tts = make_pair(kind, n_step)
    idx = np.random.default_rng(1).integers(0, E * C, B)
    key = jax.random.key(2)
    jbatch = jax.jit(lambda s, b, i, k: jalgo.preprocess(jts, jb, s, b, i, k))(
        js, jb.get(js, jnp.asarray(idx)), jnp.asarray(idx), key)
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, t(idx)), t(idx), target_draws(kind, key))
    assert tbatch.returns.shape == (B,)
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    if kind == "redq":  # another subset gives other targets
        other = target_draws(kind, key)
        other.subset = torch.tensor([3, 1]) if other.subset.tolist() != [3, 1] else torch.tensor([0, 2])
        moved = talgo.preprocess(tts, tb, ts, tb.get(ts, t(idx)), t(idx), other).returns
        assert not torch.allclose(moved, tbatch.returns)


def test_target_noise_drawn_from_a_generator_is_the_handed_noise(uniform):
    """The generator route draws what ``Draws`` hands over: standard normals of the action's shape
    (REDQ: then the subset, the first M of the argsort of N float64 uniforms)."""
    _, _, tb, ts = uniform
    idx = torch.arange(B)
    for kind in ("td3", "sac", "redq"):
        _, _, talgo, tts = make_pair(kind)
        g = torch.Generator().manual_seed(5)
        got = talgo.preprocess(tts, tb, ts, tb.get(ts, idx), idx, g).returns
        g = torch.Generator().manual_seed(5)
        draws = Draws(target=torch.randn((B, A), generator=g))
        if kind == "redq":
            draws.subset = torch.rand(N, dtype=torch.float64, generator=g).argsort()[:M]
        assert torch.equal(got, talgo.preprocess(tts, tb, ts, tb.get(ts, idx), idx, draws).returns), kind


# ---------------------------------------------------------------------------
# one update, with every draw handed over
# ---------------------------------------------------------------------------
UPDATE_CASES = {
    "ddpg": ("ddpg", 0, {}),
    "td3_step0": ("td3", 0, {}),
    "td3_step1_delayed": ("td3", 1, {}),
    "sac_fixed_alpha": ("sac", 0, {"alpha": 0.2}),
    "sac_auto_alpha": ("sac", 0, {"alpha": "auto"}),
    "redq_min": ("redq", 0, {"target_mode": "min", "actor_delay": 3}),
    "redq_mean": ("redq", 0, {"target_mode": "mean", "actor_delay": 3}),
    "redq_step4_delayed": ("redq", 4, {"target_mode": "mean", "actor_delay": 3}),
}
DELAYED = {"td3_step1_delayed", "redq_step4_delayed"}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_one_update_matches_jax(uniform, case):
    kind, step, kw = UPDATE_CASES[case]
    jb, js, tb, ts = uniform
    jalgo, jts, talgo, tts = make_pair(kind, n_step=3 if case == "sac_auto_alpha" else 1, **kw)
    jts = jts.replace(step=jnp.int32(step))
    tts.step.fill_(step)
    key = jax.random.key(3)
    jts2, _, jstats = jax.jit(lambda s, b, k: jalgo.update(s, jb, b, k, B))(jts, js, key)
    held = [k for k in ("actor", "log_alpha") if k in tts.optim] if case in DELAYED else []
    before = {k: [v.clone() for v in optimizer_tensors(tts.optim[k])] for k in held}
    out = talgo.update(tts, tb, ts, update_draws(kind, key, jb, js), B)
    assert out[0] is tts and out[1] is ts
    tstats = out[2]
    assert set(tstats.keys()) == set(jstats.keys())
    for k in tstats.keys():
        assert not tstats[k].requires_grad, k
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **TOL, err_msg=k)
    assert tts.step.shape == () and int(tts.step) == int(jts2.step) == step + 1
    assert_close_by_rule(port_state(tts), jax_state(jts2, tts))
    want, got = adam_moments(jts2, tts)
    assert_close_by_rule(got, want)
    for k in held:  # a delayed step leaves the actor (and alpha) and their Adam state as they were
        assert all(torch.equal(a, b) for a, b in zip(before[k], optimizer_tensors(tts.optim[k]))), k


def test_actor_gradients_never_reach_the_critics(uniform):
    """After an update the critics' ``.grad`` hold the critic loss's gradients only: the actor's
    backward, which runs through the stepped critics, adds nothing to them."""
    jb, js, tb, ts = uniform
    _, _, talgo, tts = make_pair("sac", alpha="auto")
    draws = update_draws("sac", jax.random.key(4), jb, js)
    batch = tb.get(ts, draws.indices)
    batch = talgo.preprocess(tts, tb, ts, batch, draws.indices, draws)
    twin = copy.deepcopy(tts)
    c1, c2 = twin.model["critic"], twin.model["critic2"]
    c_loss = ((batch.returns - c1(batch.obs, batch.act)) ** 2 + (batch.returns - c2(batch.obs, batch.act)) ** 2).mean() / 2
    want = torch.autograd.grad(c_loss, [*c1.parameters(), *c2.parameters()])
    talgo.update_step(tts, batch, draws)
    got = [p.grad for p in (*tts.model["critic"].parameters(), *tts.model["critic2"].parameters())]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in tts.model["actor"].parameters())


# ---------------------------------------------------------------------------
# prioritized replay: the TD error is written back as the new priority
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ddpg", "td3", "sac", "redq"])
def test_per_writeback_matches_jax(kind):
    jb, js, tb, ts = filled_buffers(prio=True)
    jalgo, jts, talgo, tts = make_pair(kind)
    key = jax.random.key(5)
    draws = update_draws(kind, key, jb, js)
    np.testing.assert_allclose(tb.get_weight(ts, draws.indices).numpy(),
                               np.asarray(jb.get_weight(js, jnp.asarray(draws.indices.numpy()))), rtol=1e-6)
    tree0 = ts.tree.clone()
    _, js2, jstats = jax.jit(lambda s, b, k: jalgo.update(s, jb, b, k, B))(jts, js, key)
    _, _, tstats = talgo.update(tts, tb, ts, draws, B)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js2.tree), rtol=1e-4, atol=0)
    np.testing.assert_allclose(ts.max_prio.item(), float(js2.max_prio), rtol=1e-4)
    np.testing.assert_allclose(ts.min_prio.item(), float(js2.min_prio), rtol=1e-4)
    # REDQ writes no priorities back, in either package
    assert torch.equal(ts.tree, tree0) == (kind == "redq")


# ---------------------------------------------------------------------------
# the slice as a whole: chains of updates over one buffer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,prio,kw", [("sac", False, {"alpha": "auto"}), ("td3", True, {})],
                         ids=["sac", "td3_per"])
def test_a_chain_of_updates_matches_jax(kind, prio, kw):
    jb, js, tb, ts = filled_buffers(prio=prio, steps=16, seed=2)
    jalgo, jts, talgo, tts = make_pair(kind, n_step=2, **kw)
    jupdate = jax.jit(lambda s, b, k: jalgo.update(s, jb, b, k, B))
    for i in range(4):
        key = jax.random.key(100 + i)
        draws = update_draws(kind, key, jb, js)  # the JAX rows of this step, from the JAX buffer's priorities
        jts, js, jstats = jupdate(jts, js, key)
        _, _, tstats = talgo.update(tts, tb, ts, draws, B)
        np.testing.assert_allclose(tstats.loss.numpy(), np.asarray(jstats.loss), rtol=1e-4, atol=1e-5)
    assert int(tts.step) == int(jts.step) == 4
    assert_close_by_rule(port_state(tts), jax_state(jts, tts))
    want, got = adam_moments(jts, tts)
    assert_close_by_rule(got, want)
    if prio:
        np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# acting: noise, clip and scale, and what the buffer stores
# ---------------------------------------------------------------------------
class RecordingPendulum(Pendulum):
    """Pendulum that keeps the last action it was stepped with."""

    def step(self, state, action, generator):
        self.last_action = action.clone()
        return super().step(state, action, generator)


@pytest.mark.parametrize("kind", ["ddpg", "sac"])
def test_one_collect_step_noise_clip_scale_and_the_stored_raw_action(kind):
    env = RecordingPendulum()
    nets = dict(critic=continuous.ContinuousCritic(HID, input_dim=3, action_dim=1), action_space=env.action_space)
    if kind == "ddpg":
        algo = DDPG(actor=continuous.ContinuousActorDeterministic(HID, 1, input_dim=3),
                    exploration_noise=GaussianNoise(sigma=1.5), **nets)  # wide noise: some actions leave [-1, 1]
        jalgo = JDDPG(actor=jcont.ContinuousActorDeterministic(HID, 1), critic=jcont.ContinuousCritic(HID),
                      action_space=jcore.Box(-2.0, 2.0, (1,)), exploration_noise=JGaussianNoise(sigma=1.5))
    else:
        algo = SAC(actor=continuous.ContinuousActorProbabilistic(HID, 1, conditioned_sigma=True, input_dim=3), **nets)
        jalgo = JSAC(actor=jcont.ContinuousActorProbabilistic(HID, 1, conditioned_sigma=True),
                     critic=jcont.ContinuousCritic(HID), action_space=jcore.Box(-2.0, 2.0, (1,)))
    assert algo.action_scaling and algo.action_bound_method == ("clip" if kind == "ddpg" else None)
    ts = algo.init("cpu")
    n_env = 64
    buf = VectorReplayBuffer(n_env * 4, n_env)
    bs = buf.init(Batch(obs=torch.zeros(3), act=torch.zeros(1), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                        truncated=torch.tensor(False), obs_next=torch.zeros(3)), device="cpu")
    coll = DeviceCollector(tcore.VectorDeviceEnv(env, n_env, device="cpu"), algo, buf)
    gen = torch.Generator().manual_seed(0)
    cstate = coll.reset(gen)
    obs = cstate.obs.clone()
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    coll.collect(ts, cstate, bs, gen, 1)
    with torch.no_grad():
        if kind == "ddpg":  # the actor, then the noise the generator draws first
            raw = ts.model["actor"](obs) + 1.5 * torch.randn((n_env, 1), generator=replay)
        else:  # a sample of the squashed Gaussian
            mu, sigma = ts.model["actor"](obs)
            raw = torch.tanh(mu + sigma * torch.randn((n_env, 1), generator=replay))
    stored = bs.data.act[:, 0]
    assert torch.equal(stored, raw)  # the raw action, before map_action
    if kind == "ddpg":
        assert (stored.abs() > 1).any()
    np.testing.assert_array_equal(env.last_action.numpy(), np.asarray(jalgo.map_action(jnp.asarray(raw.numpy()))))
    assert (env.last_action.abs() <= 2.0).all()
    # the test phase's step: no noise (DDPG), the mode (SAC)
    ecoll = DeviceCollector(tcore.VectorDeviceEnv(env, n_env, device="cpu"), algo, None)
    ecs = ecoll.reset(gen)
    obs = ecs.obs.clone()
    ecoll.collect(ts, ecs, None, gen, 1, training=False)
    with torch.no_grad():
        greedy = ts.model["actor"](obs) if kind == "ddpg" else torch.tanh(ts.model["actor"](obs)[0])
    assert torch.equal(env.last_action, algo.map_action(greedy))


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------
def test_train_state_layout():
    for kind, keys, targets in (("ddpg", ["actor", "critic"], ["actor", "critic"]),
                                ("td3", ["actor", "critic", "critic2"], ["actor", "critic", "critic2"]),
                                ("sac", ["actor", "critic", "critic2"], ["critic", "critic2"]),
                                ("redq", ["actor", "critic"], ["critic"])):
        _, _, talgo, _ = make_pair(kind)
        ts = talgo.init("cpu")
        assert list(ts.model.keys()) == keys and list(ts.target.keys()) == targets, kind
        assert sorted(ts.optim) == sorted(keys + (["log_alpha"] if kind in ("sac", "redq") else [])), kind
        assert all(not p.requires_grad for p in ts.target.parameters())
        for k in targets:  # the targets start as copies, in storage of their own
            for a, b in zip(ts.target[k].parameters(), ts.model[k].parameters()):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        if "critic2" in keys:  # drawn anew, as the JAX package inits it from a key of its own
            assert not torch.equal(ts.model["critic"].mlp.linears[0].weight, ts.model["critic2"].mlp.linears[0].weight)
        if kind in ("sac", "redq"):
            assert ts.model.log_alpha.shape == () and float(ts.model.log_alpha.detach()) == 0.0
            assert "log_alpha" in ts.model.state_dict() and talgo.target_entropy == -A
        for opt in ts.optim.values():  # Adam's state exists before the first step (the delayed updates snapshot it)
            assert all(len(opt.state[p]) == 3 for g in opt.param_groups for p in g["params"])
