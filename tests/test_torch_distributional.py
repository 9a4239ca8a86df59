"""The distributional slice of the port (tianshou_tpu_torch) against the JAX
package (tianshou_tpu): ``quantile_huber_loss``, the implicit-quantile nets
(``CosineEmbedding``, ``ImplicitQuantileNetwork``, ``FractionProposalNetwork``),
the MLP ``RainbowNet``, the ``IntrinsicCuriosityModule``, ``MaskedQNet``, the
Atari ``QRDQNet`` and ``ImplicitQuantileAtariNet``, and one update of
``QRDQN``, ``IQN`` and ``FQF`` over prioritized replay of frame-stacked uint8
pixels, with the sampled indices and IQN's fractions handed over
(``Draws``: JAX's ``uniform`` of the keys its update splits). Weights are
carried across by ``tianshou_tpu_torch.models.convert``.

Tolerances:
- ``quantile_huber_loss``: rtol 1e-6 (the same float32 operations).
- float32 forwards, n-step returns, losses and TD errors: rtol 1e-4 / atol
  1e-5 (float32 sums in another order).
- the bf16 NatureCNN trunk (the default) at batch 2: atol 2e-3, the bf16
  tolerance of ``tests/test_torch_rainbow.py`` (XLA and PyTorch round the
  bf16 intermediates at different places).
- parameters after one step (lr 1e-3): atol 2e-6 (0.2% of a step) for at
  least 99.9% of each tensor, as ``tests/test_torch_dqn.py`` holds DQN's, and
  atol 1e-4 (10% of a step) for all, as ``tests/test_torch_rainbow.py`` holds
  Rainbow's. Adam's and RMSprop's first step ``lr * g / sqrt(g^2 ...)`` moves
  a weight whose gradient is near eps by a share of lr set by the last bits
  of its gradient: behind the quantile Huber loss one of QRDQN's 36,864 conv
  weights moved 3.3e-5 apart, over DQN's 2e-5.
- gradients of FQF's Q loss with respect to the fraction net: rtol 1e-4 /
  atol 1e-7.
- the sum tree after the priority writeback: rtol 1e-4.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.modelfree.fqf import FQF as JFQF
from tianshou_tpu.algorithm.modelfree.iqn import IQN as JIQN
from tianshou_tpu.algorithm.modelfree.qrdqn import QRDQN as JQRDQN
from tianshou_tpu.algorithm.modelfree.qrdqn import quantile_huber_loss as j_qhl
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import discrete as jd
from tianshou_tpu.models.atari import ImplicitQuantileAtariNet as JIQNAtari
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu.models.atari import QRDQNet as JQRDQNet
from tianshou_tpu.models.mlp import Net as JNet
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN, quantile_huber_loss
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, RMSpropOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer, PrioState
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import discrete as td
from tianshou_tpu_torch.models.atari import ImplicitQuantileAtariNet, QRDQNet
from tianshou_tpu_torch.models.convert import (
    fraction_params_from_flax,
    icm_params_from_flax,
    iqn_params_from_flax,
    masked_qnet_params_from_flax,
    net_params_from_flax,
    qrdqnet_params_from_flax,
    rainbow_net_params_from_flax,
)
from tianshou_tpu_torch.models.mlp import Net
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

A, HW, FEAT, E, STACK, C = 4, 36, 32, 3, 4, 8
K, NF, S, KT, KO = 8, 6, 7, 5, 3  # quantiles, FQF fractions, IQN samples (update, target, online)
F32 = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rng(seed):
    return np.random.default_rng(seed)


def _hold_params(got_sd, want_sd, before_sd=None):
    """Parameters after a step: 99.9% of each tensor within 2e-6, all within 1e-4."""
    got = {k: v.detach().numpy() for k, v in got_sd.items()}
    assert set(got) == set(want_sd)
    for k, w in want_sd.items():
        w = w.numpy()
        if before_sd is not None:
            assert not np.array_equal(got[k], before_sd[k].numpy()), k  # every tensor trains
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4, err_msg=k)
        assert np.mean(np.abs(got[k] - w) <= 2e-6) >= 0.999, k


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kappa", [1.0, 0.5])
def test_quantile_huber_loss_matches_jax(kappa):
    rng = _rng(0)
    curr = (rng.standard_normal((4, 8)) * 2).astype(np.float32)
    target = (rng.standard_normal((4, 6)) * 2).astype(np.float32)
    taus = rng.random((4, 8)).astype(np.float32)
    u = target[:, None, :] - curr[:, :, None]
    assert (np.abs(u) > kappa).any() and (np.abs(u) <= kappa).any()  # both branches of the Huber loss
    want = np.asarray(j_qhl(jnp.asarray(curr), jnp.asarray(target), jnp.asarray(taus), kappa))
    got = quantile_huber_loss(_t(curr), _t(target), _t(taus), kappa)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------
def test_cosine_embedding_matches_jax():
    taus = _rng(1).random((3, 5)).astype(np.float32)
    m = jd.CosineEmbedding(16, 12)
    p = m.init(jax.random.key(0), jnp.asarray(taus))
    emb = td.CosineEmbedding(16, 12)
    emb.linear.load_state_dict({"weight": _t(np.asarray(p["params"]["Dense_0"]["kernel"]).T),
                                "bias": _t(p["params"]["Dense_0"]["bias"])})
    with torch.no_grad():
        got = emb(_t(taus))
    assert got.shape == (3, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(p, jnp.asarray(taus))), **F32)


def test_implicit_quantile_network_features_and_quantiles_match_jax():
    rng = _rng(2)
    obs = rng.standard_normal((4, 7)).astype(np.float32)
    taus = rng.random((4, 9)).astype(np.float32)
    m = jd.ImplicitQuantileNetwork((16, 12), 3, num_cosines=10)
    p = m.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(taus))
    net = td.ImplicitQuantileNetwork((16, 12), 3, num_cosines=10, input_dim=7)
    net.load_state_dict(iqn_params_from_flax(_np_tree(p)))
    assert td.FullQuantileFunction is td.ImplicitQuantileNetwork
    with torch.no_grad():
        feat = net.features(_t(obs))
        z = net.quantiles(feat, _t(taus))
        whole = net(_t(obs), _t(taus))
    jfeat = m.apply(p, jnp.asarray(obs), method="features")
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **F32)
    want = np.asarray(m.apply(p, jfeat, jnp.asarray(taus), method="quantiles"))
    assert z.shape == (4, 9, 3)
    np.testing.assert_allclose(z.numpy(), want, **F32)
    assert torch.equal(z, whole)


def test_fraction_proposal_network_matches_jax():
    feat = _rng(3).standard_normal((5, 12)).astype(np.float32)
    m = jd.FractionProposalNetwork(NF)
    p = m.init(jax.random.key(2), jnp.asarray(feat))
    want = [np.asarray(x) for x in m.apply(p, jnp.asarray(feat))]
    net = td.FractionProposalNetwork(NF, input_dim=12)
    bound = np.sqrt(6.0 / (12 + NF))  # xavier_uniform, as flax draws it
    w = net.linear.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound and not net.linear.bias.detach().any()
    net.load_state_dict(fraction_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        taus, tau_hats, ent = net(_t(feat))
    assert taus.shape == (5, NF + 1) and tau_hats.shape == (5, NF) and ent.shape == (5,)
    for got, w in zip((taus, tau_hats, ent), want):
        np.testing.assert_allclose(got.numpy(), w, **F32)
    assert bool((taus[:, 0] == 0).all()) and np.allclose(taus[:, -1].numpy(), 1.0, atol=1e-6)


def _layer_noise(key, in_f, out_f):
    k1, k2 = jax.random.split(key)
    f = lambda e: np.sign(np.asarray(e)) * np.sqrt(np.abs(np.asarray(e)))  # noqa: E731
    return _t(f(jax.random.normal(k1, (in_f,)))), _t(f(jax.random.normal(k2, (out_f,))))


@pytest.mark.parametrize("noisy", [False, True], ids=["mean", "noisy"])
def test_mlp_rainbow_net_matches_jax(noisy):
    obs = _rng(4).standard_normal((3, 4)).astype(np.float32)
    m = jd.RainbowNet((16, 16), 2, num_atoms=11)
    p = m.init(jax.random.key(3), jnp.asarray(obs))
    key = jax.random.key(9)
    want = np.asarray(m.apply(p, jnp.asarray(obs), noise_key=key if noisy else None))
    net = td.RainbowNet((16, 16), 2, num_atoms=11, input_dim=4)
    net.load_state_dict(rainbow_net_params_from_flax(_np_tree(p)))
    ks = jax.random.split(key, 4)
    noise = [_layer_noise(k, i, o) for k, (i, o) in zip(ks, [(16, 16), (16, 11), (16, 16), (16, 22)])]
    with torch.no_grad():
        got = net(_t(obs), noise if noisy else None)
    assert got.shape == (3, 2, 11)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_intrinsic_curiosity_module_matches_jax():
    rng = _rng(5)
    obs, obs_next = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    act = rng.integers(0, 3, 6).astype(np.int32)
    m = jd.IntrinsicCuriosityModule((8,), 3, (10,))
    p = m.init(jax.random.key(4), jnp.asarray(obs), jnp.asarray(act), jnp.asarray(obs_next))
    want = [np.asarray(x) for x in m.apply(p, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(obs_next))]
    net = td.IntrinsicCuriosityModule((8,), 3, (10,), input_dim=5)
    net.load_state_dict(icm_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        mse, act_hat = net(_t(obs), _t(act), _t(obs_next))
    assert mse.shape == (6,) and act_hat.shape == (6, 3)
    np.testing.assert_allclose(mse.numpy(), want[0], **F32)
    np.testing.assert_allclose(act_hat.numpy(), want[1], **F32)


def test_masked_qnet_matches_jax():
    rng = _rng(6)
    board = rng.standard_normal((4, 3, 3)).astype(np.float32)
    mask = rng.random((4, 9)) < 0.6
    m = jd.MaskedQNet((16,), 9)
    jobs = JBatch(obs=jnp.asarray(board), mask=jnp.asarray(mask))
    p = m.init(jax.random.key(5), jobs)
    want = np.asarray(m.apply(p, jobs))
    net = td.MaskedQNet((16,), 9, input_dim=9)
    net.load_state_dict(masked_qnet_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        got = net(Batch(obs=_t(board), mask=_t(mask)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert bool((got[~_t(mask)] == -1e9).all())


class JQRDQNet32(fnn.Module):
    """The JAX QRDQNet over a float32 NatureCNN."""

    action_dim: int
    num_quantiles: int
    features: int

    @fnn.compact
    def __call__(self, x):
        q = fnn.Dense(self.action_dim * self.num_quantiles)(JNatureCNN(self.features, jnp.float32)(x))
        return q.reshape(-1, self.action_dim, self.num_quantiles)


class JIQNAtari32(JIQNAtari):
    """The JAX ImplicitQuantileAtariNet (its own methods) over a float32 NatureCNN."""

    def setup(self):
        self.trunk = JNatureCNN(self.features_dim, jnp.float32)
        self.cos_emb = jd.CosineEmbedding(self.features_dim, self.num_cosines)
        self.merge = fnn.Dense(self.features_dim)
        self.head = fnn.Dense(self.action_dim)


@pytest.fixture(scope="module")
def frames():
    return _rng(0).integers(0, 256, (3, STACK, HW, HW, 1), dtype=np.uint8)


def test_qrdqnet_float32_matches_jax(frames):
    m = JQRDQNet32(A, K, FEAT)
    p = m.init(jax.random.key(1), jnp.asarray(frames))
    net = QRDQNet(A, K, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
    net.load_state_dict(qrdqnet_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        got = net(_t(frames))
    assert got.shape == (3, A, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(p, jnp.asarray(frames))), **F32)


def test_iqn_atari_net_float32_matches_jax(frames):
    taus = _rng(7).random((3, 5)).astype(np.float32)
    m = JIQNAtari32(A, FEAT, num_cosines=16)
    p = m.init(jax.random.key(2), jnp.asarray(frames), jnp.asarray(taus))
    net = ImplicitQuantileAtariNet(A, FEAT, num_cosines=16, compute_dtype=torch.float32, input_hw=(HW, HW))
    net.load_state_dict(iqn_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        feat = net.features(_t(frames))
        got = net.quantiles(feat, _t(taus))
    np.testing.assert_allclose(feat.numpy(), np.asarray(m.apply(p, jnp.asarray(frames), method="features")), **F32)
    assert got.shape == (3, 5, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(p, jnp.asarray(frames), jnp.asarray(taus))), **F32)


@pytest.mark.parametrize("kind", ["qrdqn", "iqn"])
def test_atari_quantile_nets_bf16_default_match_jax(kind):
    x = _rng(8).integers(0, 256, (2, STACK, 84, 84, 1), dtype=np.uint8)
    if kind == "qrdqn":
        m = JQRDQNet(6, 200)
        p = m.init(jax.random.key(3), jnp.asarray(x))
        want = np.asarray(m.apply(p, jnp.asarray(x)))
        net = QRDQNet(6, 200)
        net.load_state_dict(qrdqnet_params_from_flax(_np_tree(p)))  # every key and shape matches
        with torch.no_grad():
            got = net(_t(x))
        assert got.shape == (2, 6, 200)
    else:
        taus = _rng(9).random((2, 32)).astype(np.float32)
        m = JIQNAtari(6)
        p = m.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(taus))
        want = np.asarray(m.apply(p, jnp.asarray(x), jnp.asarray(taus)))
        net = ImplicitQuantileAtariNet(6)
        net.load_state_dict(iqn_params_from_flax(_np_tree(p)))
        with torch.no_grad():
            got = net(_t(x), _t(taus))
        assert got.shape == (2, 32, 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# one update of QRDQN, IQN and FQF over prioritized replay against JAX
# ---------------------------------------------------------------------------
def _example(jax_side):
    ex = dict(obs=np.zeros((HW, HW, 1), np.uint8), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros((HW, HW, 1), np.uint8))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


@pytest.fixture(scope="module")
def filled():
    """Both PER buffers with the same 13 steps and the same unequal priorities."""
    rng = _rng(0)
    kw = dict(alpha=0.6, beta=0.4, stack_num=STACK, save_only_last_obs=True)
    jb, tb = JPVRB(E * C, E, **kw), PrioritizedVectorReplayBuffer(E * C, E, **kw)
    js, ts = jb.init(_example(True)), tb.init(_example(False), device="cpu")
    for _ in range(13):
        step = dict(
            obs=rng.integers(0, 256, (E, STACK, HW, HW, 1), dtype=np.uint8),
            act=rng.integers(0, A, E).astype(np.int32),
            rew=rng.standard_normal(E).astype(np.float32),
            terminated=rng.random(E) < 0.15,
            truncated=rng.random(E) < 0.05,
            obs_next=rng.integers(0, 256, (E, STACK, HW, HW, 1), dtype=np.uint8),
        )
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    idx0 = rng.integers(0, E * C, 12)
    td0 = (rng.standard_normal(12) * 2).astype(np.float32)
    js = jb.update_weight(js, jnp.asarray(idx0), jnp.asarray(td0))
    tb.update_weight(ts, torch.from_numpy(idx0), torch.from_numpy(td0))
    return jb, js, tb, ts, rng.integers(0, E * C, 16)


def _algos(kind, n_step=3, fraction_lr=1e-3):
    kw = dict(gamma=0.9, n_step_return_horizon=n_step, target_update_freq=2)
    obs = jnp.zeros((STACK, HW, HW, 1), jnp.uint8)
    jspace, tspace = jcore.Discrete(A), tcore.Discrete(A)
    if kind == "qrdqn":
        jalgo = JQRDQN(model=JQRDQNet32(A, K, FEAT), action_space=jspace, optim=JAdam(lr=1e-3), num_quantiles=K, **kw)
        jts = jalgo.init(jax.random.key(0), obs)
        net = QRDQNet(A, K, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
        net.load_state_dict(qrdqnet_params_from_flax(_np_tree(jts.params["model"])))
        talgo = QRDQN(model=net, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3), num_quantiles=K, **kw)
        return jalgo, jts, talgo, talgo.init("cpu")
    net = ImplicitQuantileAtariNet(A, FEAT, num_cosines=16, compute_dtype=torch.float32, input_hw=(HW, HW))
    jnet = JIQNAtari32(A, FEAT, num_cosines=16)
    if kind == "iqn":
        samples = dict(sample_size=S, online_sample_size=KO, target_sample_size=KT)
        jalgo = JIQN(model=jnet, action_space=jspace, optim=JAdam(lr=1e-3), **samples, **kw)
        jts = jalgo.init(jax.random.key(0), obs)
        net.load_state_dict(iqn_params_from_flax(_np_tree(jts.params["model"])))
        talgo = IQN(model=net, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3), **samples, **kw)
        return jalgo, jts, talgo, talgo.init("cpu")
    jfrac = optax.rmsprop(fraction_lr) if fraction_lr is not None else None
    tfrac = RMSpropOptimizerFactory(lr=fraction_lr, alpha=0.9) if fraction_lr is not None else None
    jalgo = JFQF(model=jnet, action_space=jspace, optim=JAdam(lr=1e-3), num_fractions=NF, ent_coef=10.0,
                 fraction_optim=jfrac, **kw)
    jts = jalgo.init(jax.random.key(0), obs)
    net.load_state_dict(iqn_params_from_flax(_np_tree(jts.params["model"])))
    talgo = FQF(model=net, action_space=tspace, optim=AdamOptimizerFactory(lr=1e-3), num_fractions=NF, ent_coef=10.0,
                fraction_optim=tfrac, **kw)
    talgo.fraction_net.load_state_dict(fraction_params_from_flax(_np_tree(jts.params["fraction"])))
    return jalgo, jts, talgo, talgo.init("cpu")


def _iqn_draws(k2, k3, batch):
    """IQN's fractions as the JAX update draws them: ``_target_q`` splits its key (k2) in two."""
    ka, kb = jax.random.split(k2)
    return Draws(taus=_t(jax.random.uniform(k3, (batch, S))), target_taus=_t(jax.random.uniform(ka, (batch, KT))),
                 online_taus=_t(jax.random.uniform(kb, (batch, KO))))


def _jax_update(jalgo, jts, jb, js, idx, key):
    """JAX's preprocess, gradient step and writeback on handed indices, from ``key``'s k2 and k3."""
    _, k2, k3 = jax.random.split(key, 3)
    jidx = jnp.asarray(idx)
    jbatch = jb.get(js, jidx, drop_keys=jalgo.update_sample_drop_keys)
    jbatch.weight = jb.get_weight(js, jidx)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, k2))(jts, js, jbatch)
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, k3)
    return jbatch, jts2, jstats, jalgo.postprocess(jts2, jb, js, jbatch, jidx, jstats), (k2, k3)


@pytest.mark.parametrize("kind,n_step", [("qrdqn", 3), ("qrdqn", 1), ("iqn", 3), ("fqf", 3)])
def test_one_quantile_update_over_per_matches_jax(filled, kind, n_step):
    jb, js, tb, ts, idx = filled
    ts = PrioState(ts.base, ts.tree.clone(), ts.max_prio.clone(), ts.min_prio.clone())  # the writeback is in place
    jalgo, jts, talgo, tts = _algos(kind, n_step)
    drop = jalgo.update_sample_drop_keys
    assert talgo.update_sample_drop_keys == drop == (("obs_next",) if n_step > 1 else ())
    jbatch, jts2, jstats, js2, (k2, k3) = _jax_update(jalgo, jts, jb, js, idx, jax.random.key(1))

    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=drop)
    tbatch.weight = tb.get_weight(ts, tidx)
    assert float(tbatch.weight.min()) < 1.0  # the priorities are unequal, so the weights matter
    draws = _iqn_draws(k2, k3, len(idx)) if kind == "iqn" else torch.Generator()
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, draws)
    width = {"qrdqn": K, "iqn": KT, "fqf": NF}[kind]
    assert tbatch.returns.shape == (16, width)
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **F32)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    tts, tstats = talgo.update_step(tts, tbatch, draws)
    for name in ("loss", "q_loss", "fraction_loss") if kind == "fqf" else ("loss",):
        np.testing.assert_allclose(tstats[name].item(), float(jstats[name]), **F32, err_msg=name)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **F32)
    assert not tstats.td_error.requires_grad and tstats.td_error.shape == (16,)
    if kind == "fqf":  # both parameter groups, each by its own optimizer
        _hold_params(tts.model["model"].state_dict(), iqn_params_from_flax(_np_tree(jts2.params["model"])),
                     {k[len("model."):]: v for k, v in before.items() if k.startswith("model.")})
        _hold_params(tts.model["fraction"].state_dict(), fraction_params_from_flax(_np_tree(jts2.params["fraction"])),
                     {k[len("fraction."):]: v for k, v in before.items() if k.startswith("fraction.")})
    else:
        convert = qrdqnet_params_from_flax if kind == "qrdqn" else iqn_params_from_flax
        _hold_params(tts.model.state_dict(), convert(_np_tree(jts2.params["model"])), before)
    assert int(tts.step) == int(jts2.step) == 1
    # priority writeback: the TD error of the means becomes the new priority
    assert talgo.postprocess(tts, tb, ts, tbatch, tidx, tstats) is ts
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js2.tree), rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", ["qrdqn", "iqn", "fqf"])
def test_target_sync_on_the_same_steps_as_jax(filled, kind):
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos(kind)
    jbatch, _, _, _, (k2, k3) = _jax_update(jalgo, jts, jb, js, idx, jax.random.key(2))
    tidx = torch.from_numpy(idx)
    draws = _iqn_draws(k2, k3, len(idx)) if kind == "iqn" else torch.Generator()
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys), tidx, draws)
    online = (lambda t: t.model["model"]) if kind == "fqf" else (lambda t: t.model)
    synced = []
    for _ in range(4):
        tts, _ = talgo.update_step(tts, tbatch, draws)
        synced.append(all(torch.equal(a, b) for a, b in zip(tts.target.parameters(), online(tts).parameters())))
    assert synced == [False, True, False, True]


def test_iqn_forward_takes_handed_or_drawn_taus(filled):
    _, _, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos("iqn")
    obs = tb.get(ts, torch.from_numpy(idx), keys=("obs",)).obs
    key = jax.random.key(5)
    jout = jalgo.forward(jts, jnp.asarray(obs.numpy()), key)
    out = talgo.forward(tts, obs, Draws(taus=_t(jax.random.uniform(key, (16, S)))))
    np.testing.assert_allclose(out.info.q.numpy(), np.asarray(jout.info.q), **F32)
    assert torch.equal(out.act, torch.from_numpy(np.asarray(jout.act)).to(torch.int64))
    a = talgo.forward(tts, obs, torch.Generator().manual_seed(3)).info.q
    g = torch.Generator().manual_seed(3)
    b = talgo.forward(tts, obs, Draws(taus=torch.rand((16, S), generator=g))).info.q
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# FQF's traps: the fraction optimizer's default and the gradient through tau_hats
# ---------------------------------------------------------------------------
def test_fqf_default_fraction_optimizer_is_optax_rmsprop(filled):
    """optax.rmsprop(2.5e-9) decays by 0.9 (the torch factory's default alpha is 0.99)."""
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos("fqf", fraction_lr=None)
    factory = talgo.fraction_optim
    assert isinstance(factory, RMSpropOptimizerFactory) and (factory.lr, factory.alpha, factory.eps) == (2.5e-9, 0.9, 1e-8)
    jbatch, jts2, _, _, _ = _jax_update(jalgo, jts, jb, js, idx, jax.random.key(3))
    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys)
    tbatch.weight = tb.get_weight(ts, tidx)
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    tts, _ = talgo.update_step(tts, tbatch)
    jnu = _np_tree(jts2.opt_state["fraction"][0].nu["params"]["Dense_0"])
    opt = tts.optim["fraction"]
    got = {name: opt.state[p]["square_avg"].numpy() for name, p in tts.model["fraction"].named_parameters()}
    np.testing.assert_allclose(got["linear.weight"], jnu["kernel"].T, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got["linear.bias"], jnu["bias"], rtol=1e-4, atol=1e-12)
    assert float(np.abs(jnu["kernel"]).max()) > 0


def test_fqf_q_loss_reaches_the_fraction_net_through_tau_hats(filled):
    """The gradient of the Q loss alone with respect to the fraction net, as
    JAX takes it: nonzero, through the quantiles at ``tau_hats`` and the
    Huber weights ``|tau_hat - 1{u < 0}|``."""
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos("fqf")
    jbatch, _, _, _, _ = _jax_update(jalgo, jts, jb, js, idx, jax.random.key(4))
    m_params, f_params = jts.params["model"], jts.params["fraction"]
    act = jbatch.act.astype(jnp.int32)

    def j_q_loss(fp):
        feat = jalgo.model.apply(m_params, jbatch.obs, method="features")
        _, tau_hats, _ = jalgo.fraction_net.apply(fp, feat)
        z = jalgo.model.apply(m_params, feat, tau_hats, method="quantiles")
        curr = jnp.take_along_axis(z, act[:, None, None], axis=2)[..., 0]
        return (jbatch.weight * j_qhl(curr, jbatch.returns, tau_hats)).mean()

    want = _np_tree(jax.grad(j_q_loss)(f_params)["params"]["Dense_0"])
    tbatch = Batch({k: _t(np.asarray(jbatch[k])) for k in ("obs", "act", "returns", "weight")})
    _, q_loss, _, _ = talgo.losses(tts.model, tbatch)
    fnet = tts.model["fraction"]
    gw, gb = torch.autograd.grad(q_loss, [fnet.linear.weight, fnet.linear.bias])
    assert float(gw.abs().max()) > 1e-6
    np.testing.assert_allclose(gw.numpy(), want["kernel"].T, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), want["bias"], rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the small API gaps: compute_action
# ---------------------------------------------------------------------------
def test_compute_action_numpy_in_numpy_out_matches_jax():
    obs = _rng(10).standard_normal(4).astype(np.float32)
    jalgo = JDQN(model=JNet((16,), 3), action_space=jcore.Discrete(3))
    jts = jalgo.init(jax.random.key(0), jnp.zeros(4))
    net = Net((16,), 3, input_dim=4)
    net.load_state_dict(net_params_from_flax(_np_tree(jts.params["model"])))
    talgo = DQN(model=net, action_space=tcore.Discrete(3))
    got = talgo.compute_action(talgo.init("cpu"), obs)
    assert isinstance(got, np.ndarray) and got.shape == ()
    assert int(got) == int(jalgo.compute_action(jts, obs))


# ---------------------------------------------------------------------------
# the trainer drives the family on frame-stacked pixels, on the CPU
# ---------------------------------------------------------------------------
class TPix(tcore.Env):
    """Deterministic pixel env: obs from a position pattern, episodes of 5 steps."""

    def __init__(self):
        self.observation_space = tcore.Box(0, 255, (HW, HW, 1))
        self.action_space = tcore.Discrete(A)

    def _obs(self, pos):
        row, col = torch.arange(HW)[:, None], torch.arange(HW)[None, :]
        return ((row * 7 + col * 13 + pos[:, None, None] * 3) % 251).to(torch.uint8)[..., None]

    def reset(self, num_envs, generator, device):
        z = torch.zeros(num_envs, dtype=torch.int32, device=device)
        return (z, z.clone()), self._obs(z)

    def step(self, s, a, generator):
        pos, t = s[0] + a.to(torch.int32) + 1, s[1] + 1
        return tcore.EnvStep(state=(pos, t), obs=self._obs(pos), reward=(a == pos % A).to(torch.float32),
                             terminated=t >= 5, truncated=torch.zeros_like(t, dtype=torch.bool), info=Batch())


@pytest.mark.parametrize("kind", ["qrdqn", "iqn", "fqf", "discrete_sac"])
def test_off_policy_trainer_runs_the_family_on_pixels_on_cpu(kind):
    from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.wrappers import FrameStack
    from tianshou_tpu_torch.models.atari import DQNet
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(0)
    space = tcore.Discrete(A)
    q_kw = dict(action_space=space, optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9, n_step_return_horizon=3,
                target_update_freq=3, eps_training=0.1)
    iqn_net = ImplicitQuantileAtariNet(A, FEAT, num_cosines=16, compute_dtype=torch.float32, input_hw=(HW, HW))
    if kind == "qrdqn":
        algo = QRDQN(model=QRDQNet(A, K, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)), num_quantiles=K, **q_kw)
    elif kind == "iqn":
        algo = IQN(model=iqn_net, sample_size=S, online_sample_size=KO, target_sample_size=KT, **q_kw)
    elif kind == "fqf":
        algo = FQF(model=iqn_net, num_fractions=NF, fraction_optim=RMSpropOptimizerFactory(lr=1e-3, alpha=0.9), **q_kw)
    else:
        net = DQNet(A, features=FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
        algo = DiscreteSAC(actor=net, critic=net, action_space=space, policy_optim=AdamOptimizerFactory(lr=1e-3),
                           critic_optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9, n_step_return_horizon=3)
    tts = algo.init("cpu")
    init_params = [p.detach().clone() for p in tts.model.parameters()]
    tb = VectorReplayBuffer(E * 16, E, stack_num=STACK, save_only_last_obs=True)
    ts = tb.init(_example(False), device="cpu")
    coll = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(TPix(), STACK), E, device="cpu"), algo, tb)
    test = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(TPix(), STACK), E, device="cpu"), algo, None)
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=3 * 4 * E, batch_size=8,
                                    collection_step_num_env_steps=4, update_per_step=0.5, start_steps=4 * E,
                                    test_step_num_episodes=E, verbose=False)
    res = OffPolicyTrainer(algo, coll, test, tb, params).run(tts, ts, torch.Generator().manual_seed(0))
    n_updates = round(0.5 * 4 * E)
    assert res.gradient_step == int(res.train_state.step) == 3 * n_updates
    stats = res.last_chunk_stats
    assert stats.loss.shape == (n_updates,) and stats.td_error.shape == (n_updates, 8)
    assert bool(torch.isfinite(stats.loss).all()) and bool(torch.isfinite(stats.td_error).all())
    assert all(bool(torch.isfinite(p).all()) for p in tts.model.parameters())
    assert not any(torch.equal(a, b) for a, b in zip(init_params, tts.model.parameters()))
