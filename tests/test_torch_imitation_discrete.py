"""The discrete offline family of the port (``ImitationLearning`` on logits,
``DiscreteBCQ``, ``DiscreteCQL``, ``DiscreteCRR``) against the JAX package.

Each algorithm takes one update in both packages from the same weights
(flax's, carried across by ``tianshou_tpu_torch.models.convert``; the target
nets moved away from the online ones, so that a test sees which net is read)
over the same rows, in two buffers filled with the same numpy transitions:

- a frame-stacked uint8 ring (``stack_num=4``, ``save_only_last_obs``, 3 env
  rings of 8 slots, 36x36 frames) under float32 NatureCNN nets, so that the
  buffer's ``get`` / ``_stacked`` and the n-step chain are compared too;
- CartPole-shaped rows (4 floats, 2 actions) under MLPs.

The port's ``update`` takes the sampled rows as ``Draws(indices=...)``; the
JAX side gathers the same rows and runs its ``preprocess`` and
``update_step``. Nothing in these updates draws a random number.

Tolerances:
- returns, losses and TD errors: rtol 1e-5 / atol 1e-6 under the MLPs (the
  family's float32 rule), rtol 1e-4 / atol 1e-5 under the conv nets (float32
  convolutions sum in another order);
- the weights after one Adam step (lr 1e-3): 99.9% of each tensor within
  2e-6, and all within 2e-5 under the MLPs (``tests/test_torch_dqn.py``'s
  rule) and 1e-4 under the conv nets (``tests/test_torch_rainbow.py``'s):
  Adam's first step moves a weight whose gradient is near eps by a share of
  lr that the gradient's last bits decide (one of CRR's 36,864 actor conv
  weights moved 7.5e-5 apart);
- actions, masks and sampled rows: exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.imitation.bc import ImitationLearning as JBC
from tianshou_tpu.algorithm.imitation.discrete_bcq import DiscreteBCQ as JDiscreteBCQ
from tianshou_tpu.algorithm.imitation.discrete_cql import DiscreteCQL as JDiscreteCQL
from tianshou_tpu.algorithm.imitation.discrete_crr import DiscreteCRR as JDiscreteCRR
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu.models.discrete import DiscreteActor as JActor
from tianshou_tpu.models.discrete import DiscreteCritic as JCritic
from tianshou_tpu.models.mlp import Net as JNet
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models.atari import DQNet, QRDQNet
from tianshou_tpu_torch.models.convert import dqnet_params_from_flax, mlp_params_from_flax, net_params_from_flax
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.models.mlp import Net
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

A, HW, FEAT, STACK, E, C, B, K = 4, 36, 32, 4, 3, 8, 8, 6   # pixel ring: actions, frame side, trunk width, ...
OBS, CA, CE, CC = 4, 2, 4, 16                                # CartPole rows: width, actions, rings, slots
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
CNN_TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x))


class JDQNet32(fnn.Module):
    """The JAX DQNet over a float32 NatureCNN (its default computes in bf16)."""

    action_dim: int
    features: int = FEAT

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.action_dim)(JNatureCNN(self.features, jnp.float32)(x))


class JQRDQNet32(fnn.Module):
    action_dim: int
    num_quantiles: int
    features: int = FEAT

    @fnn.compact
    def __call__(self, x):
        q = fnn.Dense(self.action_dim * self.num_quantiles)(JNatureCNN(self.features, jnp.float32)(x))
        return q.reshape(-1, self.action_dim, self.num_quantiles)


def _mlp_sd(p):
    """``state_dict`` of a ``DiscreteActor`` / ``DiscreteCritic`` (scope ``MLP_0``)."""
    return mlp_params_from_flax(_np_tree(p)["params"]["MLP_0"], "mlp.")


def _cnn(kind):
    """(JAX net, port net, converter) of the pixel case."""
    if kind == "qr":
        return (JQRDQNet32(A, K), QRDQNet(A, K, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)),
                lambda p: dqnet_params_from_flax(_np_tree(p)))
    return (JDQNet32(A), DQNet(A, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)),
            lambda p: dqnet_params_from_flax(_np_tree(p)))


def _mlp(kind):
    """(JAX net, port net, converter) of the CartPole case: Q net, logits or a distributional Q net."""
    if kind == "q":
        return JNet((16, 16), CA), Net((16, 16), CA, input_dim=OBS), lambda p: net_params_from_flax(_np_tree(p))
    if kind == "qr":
        return (JNet((16, 16), CA, num_atoms=K), Net((16, 16), CA, num_atoms=K, input_dim=OBS),
                lambda p: net_params_from_flax(_np_tree(p)))
    if kind == "critic":
        return JCritic((16, 16), last_size=CA), DiscreteCritic((16, 16), last_size=CA, input_dim=OBS), _mlp_sd
    return JActor((16, 16), CA), DiscreteActor((16, 16), CA, input_dim=OBS), _mlp_sd


def _example(pixels, jax_side):
    obs = np.zeros((HW, HW, 1), np.uint8) if pixels else np.zeros(OBS, np.float32)
    ex = dict(obs=obs, act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False), truncated=np.bool_(False),
              obs_next=obs)
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def _fill(pixels):
    """Both packages' buffers with the same transitions: (JAX buffer, state, port buffer, state, rows)."""
    rng = np.random.default_rng(0)
    if pixels:
        kw = dict(stack_num=STACK, save_only_last_obs=True)
        envs, slots, steps, acts = E, C, 11, A
    else:
        kw, envs, slots, steps, acts = {}, CE, CC, 13, CA
    jb, tb = JVRB(envs * slots, envs, **kw), VectorReplayBuffer(envs * slots, envs, **kw)
    js, ts = jb.init(_example(pixels, True)), tb.init(_example(pixels, False), device="cpu")
    for _ in range(steps):
        if pixels:
            obs = rng.integers(0, 256, (envs, STACK, HW, HW, 1), dtype=np.uint8)
            obs_next = rng.integers(0, 256, (envs, STACK, HW, HW, 1), dtype=np.uint8)
        else:
            obs, obs_next = (rng.standard_normal((envs, OBS)).astype(np.float32) for _ in range(2))
        term = rng.random(envs) < 0.15
        step = dict(obs=obs, act=rng.integers(0, acts, envs).astype(np.int32),
                    rew=rng.standard_normal(envs).astype(np.float32), terminated=term,
                    truncated=(rng.random(envs) < 0.1) & ~term, obs_next=obs_next)
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts, rng.integers(0, envs * slots, B)


@pytest.fixture(scope="module")
def rings():
    return {"pixels": _fill(True), "rows": _fill(False)}


def _moved(tree):
    """A copy of a parameter tree away from it (the target nets)."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x) * np.float32(0.8) + np.float32(0.01)), tree)


def _build(name, pixels, **kw):
    """(JAX algo, JAX train state, port algo, port train state, converter of a JAX params dict to the port
    model's ``state_dict``) with the same weights, the targets moved away from the online nets."""
    jspace, tspace = jcore.Discrete(A if pixels else CA), tcore.Discrete(A if pixels else CA)
    obs = jnp.zeros((STACK, HW, HW, 1), jnp.uint8) if pixels else jnp.zeros(OBS)
    pick = _cnn if pixels else _mlp
    opt = dict(optim=JAdam(lr=1e-3))
    if name == "bc":
        jnet, tnet, conv = pick("logits")
        jalgo = JBC(model=jnet, action_space=jspace, **opt)
        talgo = ImitationLearning(model=tnet, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3))
        convert = lambda params: conv(params["model"])  # noqa: E731
    else:
        if name == "bcq":
            (jq, tq, cq), (ji, ti, ci) = pick("q"), pick("logits")
            nets = {"model": (tq, cq), "imitator": (ti, ci)}
            jalgo = JDiscreteBCQ(model=jq, imitator=ji, action_space=jspace, **opt, **kw)
            talgo = DiscreteBCQ(model=tq, imitator=ti, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3), **kw)
        elif name == "cql":
            jq, tq, cq = pick("qr")
            nets = None
            jalgo = JDiscreteCQL(model=jq, action_space=jspace, num_quantiles=K, **opt, **kw)
            talgo = DiscreteCQL(model=tq, action_space=tspace, num_quantiles=K, optim=AdamOptimizerFactory(lr=1e-3),
                                **kw)
        else:
            (ja, ta, ca), (jc, tc, cc) = pick("logits"), pick("q" if pixels else "critic")
            nets = {"actor": (ta, ca), "critic": (tc, cc)}
            jalgo = JDiscreteCRR(actor=ja, critic=jc, action_space=jspace, **opt, **kw)
            talgo = DiscreteCRR(actor=ta, critic=tc, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3), **kw)
        if nets is None:
            convert = lambda params: cq(params["model"])  # noqa: E731
        else:
            convert = lambda params: {f"{k}.{n}": v for k, (_, c) in nets.items()  # noqa: E731
                                      for n, v in c(params[k]).items()}
    jts = jalgo.init(jax.random.key(0), obs)
    if jts.target_params:
        jts = jts.replace(target_params=_moved(jts.target_params))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(convert(jts.params))
    if tts.target is not None:
        tts.target.load_state_dict(convert(jts.target_params))
    return jalgo, jts, talgo, tts, convert


def _hold(got_sd, want_sd, pixels):
    assert set(got_sd) == set(want_sd)
    for k, w in want_sd.items():
        got, w = got_sd[k].detach().numpy(), w.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 if pixels else 2e-5, err_msg=k)
        assert np.mean(np.abs(got - w) <= 2e-6) >= 0.999, k


def _one_update(rings, name, pixels, **kw):
    """One update in both packages over the same rows; returns what the checks need."""
    jb, js, tb, ts, idx = rings["pixels" if pixels else "rows"]
    jalgo, jts, talgo, tts, convert = _build(name, pixels, **kw)
    assert talgo.update_sample_drop_keys == (("obs_next",) if name in ("bcq", "cql") and kw.get(
        "n_step_return_horizon", 1) > 1 else ())
    jidx = jnp.asarray(idx)
    key = jax.random.key(1)
    _, k2, k3 = jax.random.split(key, 3)
    jbatch = jb.get(js, jidx, drop_keys=jalgo.update_sample_drop_keys)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, k2))(jts, js, jbatch)
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, k3)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    target_before = None if tts.target is None else {k: v.clone() for k, v in tts.target.state_dict().items()}
    out = talgo.update(tts, tb, ts, Draws(indices=_t(idx).long()), B)
    assert out[0] is tts and out[1] is ts
    return dict(jbatch=jbatch, jts2=jts2, jstats=jstats, tts=tts, tstats=out[2], convert=convert, before=before,
                target_before=target_before, tb=tb, ts=ts, idx=idx, talgo=talgo)


def _check(r, pixels, names):
    tol = CNN_TOL if pixels else MLP_TOL
    tstats, jstats = r["tstats"], r["jstats"]
    assert set(tstats.keys()) == set(jstats.keys())
    for k in names:
        assert not tstats[k].requires_grad, k
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **tol, err_msg=k)
    tts, jts2 = r["tts"], r["jts2"]
    assert int(tts.step) == int(jts2.step) == 1
    _hold(tts.model.state_dict(), r["convert"](jts2.params), pixels)
    for k, v in r["before"].items():  # every net trains
        assert not torch.equal(tts.model.state_dict()[k], v), k
    if tts.target is not None:
        _hold(tts.target.state_dict(), r["convert"](jts2.target_params), pixels)


# ---------------------------------------------------------------------------
# one update of each class, over the pixel ring and over CartPole rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pixels", [True, False], ids=["pixels", "rows"])
def test_behaviour_cloning_on_logits_matches_jax(rings, pixels):
    r = _one_update(rings, "bc", pixels)
    _check(r, pixels, ["loss"])


@pytest.mark.parametrize("pixels,n_step", [(True, 1), (False, 3)], ids=["pixels_n1", "rows_n3"])
def test_discrete_bcq_matches_jax(rings, pixels, n_step):
    """The pixel path's n = 1 and the reference CartPole test's n = 3; the target net syncs every 2 steps,
    so after the first it is still the moved copy, and the returns read it."""
    r = _one_update(rings, "bcq", pixels, n_step_return_horizon=n_step, target_update_freq=2, gamma=0.9,
                    unlikely_action_threshold=0.3, imitation_logits_penalty=0.05)
    _check(r, pixels, ["loss", "ce_loss", "td_error"])
    np.testing.assert_allclose(r["tstats"].td_error.numpy(), np.asarray(r["jstats"].td_error),
                               **(CNN_TOL if pixels else MLP_TOL))
    for k, v in r["target_before"].items():  # no sync at step 1
        assert torch.equal(r["tts"].target.state_dict()[k], v), k


@pytest.mark.parametrize("pixels,n_step", [(True, 1), (False, 3)], ids=["pixels_n1", "rows_n3"])
def test_discrete_cql_matches_jax(rings, pixels, n_step):
    r = _one_update(rings, "cql", pixels, n_step_return_horizon=n_step, target_update_freq=1, gamma=0.9,
                    min_q_weight=3.0)
    _check(r, pixels, ["loss", "qr_loss", "cql_loss", "td_error"])
    # a sync every step: the target is the online net after the step
    assert all(torch.equal(a, b) for a, b in zip(r["tts"].target.parameters(), r["tts"].model.parameters()))


@pytest.mark.parametrize("pixels,mode,freq", [(True, "exp", 3), (False, "exp", 0), (False, "binary", 3),
                                              (False, "all", 3)],
                         ids=["pixels_exp_target", "rows_exp_online", "rows_binary", "rows_all"])
def test_discrete_crr_matches_jax(rings, pixels, mode, freq):
    """Each improvement mode; with a target net (the lagged nets give the one-step target) and without
    (the online ones do). ``ratio_upper_bound`` 1.5 and beta 0.5 put some weights on the clip."""
    r = _one_update(rings, "crr", pixels, policy_improvement_mode=mode, target_update_freq=freq, gamma=0.9,
                    ratio_upper_bound=1.5, beta=0.5, min_q_weight=2.0)
    _check(r, pixels, ["loss", "actor_loss", "critic_loss"])


def test_the_pixel_updates_gather_as_the_jax_fields_say(rings, monkeypatch):
    """Per update on the frame-stacked ring: ``get`` gathers each stacked field it returns in ONE
    ``[B * 4]``-row ``gather_rows`` call. BCQ and CQL at n = 1 sample ``obs`` and ``obs_next`` and reuse
    the sampled ``obs_next`` as the n-step terminal row (``_nstep_terminal``); CRR samples both; at n = 3
    BCQ and CQL drop the sampled ``obs_next`` and gather the terminal row's: 2 calls each."""
    from tianshou_tpu_torch.data.buffer import base

    calls = []
    real = base.gather_rows
    monkeypatch.setattr(base, "gather_rows", lambda src, idx: calls.append(int(idx.numel())) or real(src, idx))
    _, _, tb, ts, idx = rings["pixels"]
    for name, kw in (("bc", {}), ("bcq", dict(n_step_return_horizon=1)), ("cql", dict(n_step_return_horizon=1)),
                     ("crr", {}), ("bcq", dict(n_step_return_horizon=3)), ("cql", dict(n_step_return_horizon=3))):
        _, _, talgo, tts, _ = _build(name, True, **kw)
        calls.clear()
        talgo.update(tts, tb, ts, Draws(indices=_t(idx).long()), B)
        assert calls == [B * STACK] * 2, (name, kw, calls)


# ---------------------------------------------------------------------------
# DiscreteBCQ's action filter
# ---------------------------------------------------------------------------
def test_discrete_bcq_filter_keeps_an_action_exactly_on_the_threshold():
    """Logits ``[0, log tau, log tau - 1 ulp, -40]`` with tau = 1e-9: every ``exp`` of the shifted
    logits but the first is below float32's half ulp of 1, so ``logsumexp`` is exactly 0 and
    ``logp - max logp`` is the logits themselves, bit for bit in both packages. The action exactly
    on the threshold stays (``>=``), the one an ulp below it does not; Q prefers the dropped ones."""
    tau = 1e-9
    jalgo = JDiscreteBCQ(model=JNet((8,), 4), imitator=JActor((8,), 4), action_space=jcore.Discrete(4),
                         unlikely_action_threshold=tau)
    talgo = DiscreteBCQ(model=Net((8,), 4, input_dim=2), imitator=DiscreteActor((8,), 4, input_dim=2),
                        action_space=tcore.Discrete(4), unlikely_action_threshold=tau)
    assert np.float32(talgo.log_tau) == np.float32(jalgo.log_tau) and talgo.log_tau == jalgo.log_tau
    log_tau = np.float32(jalgo.log_tau)
    logits = np.array([[0.0, log_tau, np.nextafter(log_tau, np.float32(-np.inf)), -40.0],
                       [log_tau, 0.0, -40.0, np.nextafter(log_tau, np.float32(np.inf))]], np.float32)
    q = np.array([[1.0, 2.0, 5.0, 9.0], [3.0, 1.0, 8.0, 2.5]], np.float32)

    class Fixed(torch.nn.Module):
        def __init__(self, value):
            super().__init__()
            self.value = torch.from_numpy(value)

        def forward(self, obs):
            return self.value

    jmask = jax.nn.log_softmax(jnp.asarray(logits), -1)
    jmask = np.asarray(jmask - jmask.max(-1, keepdims=True) >= jalgo.log_tau)
    assert jmask.tolist() == [[True, True, False, False], [True, True, False, True]]
    want = np.asarray(jnp.argmax(jnp.where(jmask, jnp.asarray(q), -jnp.inf), -1))
    act, got_q = talgo._select(torch.nn.ModuleDict({"model": Fixed(q), "imitator": Fixed(logits)}), torch.zeros(2, 2))
    assert act.tolist() == want.tolist() == [1, 0]
    assert torch.equal(got_q, torch.from_numpy(q))


def test_discrete_bcq_acting_matches_jax():
    """Acting on CartPole rows: the filtered greedy action and Q, from the same weights."""
    jalgo, jts, talgo, tts, _ = _build("bcq", False, unlikely_action_threshold=0.6)
    obs = np.random.default_rng(3).standard_normal((16, OBS)).astype(np.float32)
    jout = jalgo.forward(jts, jnp.asarray(obs), jax.random.key(0))
    tout = talgo.forward(tts, _t(obs))
    assert tout.act.tolist() == np.asarray(jout.act).tolist()
    np.testing.assert_allclose(tout.info.q.numpy(), np.asarray(jout.info.q), **MLP_TOL)


@pytest.mark.parametrize("name", ["bc", "crr"])
def test_discrete_acting_matches_jax(name):
    """BC acts by the argmax of its logits; CRR by the mode when deterministic."""
    jalgo, jts, talgo, tts, _ = _build(name, False)
    obs = np.random.default_rng(4).standard_normal((16, OBS)).astype(np.float32)
    jact = jalgo.forward(jts, jnp.asarray(obs), jax.random.key(0), deterministic=True).act
    assert talgo.forward(tts, _t(obs), torch.Generator(), deterministic=True).act.tolist() == np.asarray(jact).tolist()
