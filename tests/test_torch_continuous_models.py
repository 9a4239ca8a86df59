"""The port's continuous-control pieces of the off-policy family against the
JAX package: ``TanhNormal``, both continuous actors, ``EnsembleLinear`` and
``EnsembleCritic``, the exploration noises and ``polyak_update``.

Inputs are numpy arrays from a seed, weights are flax's (carried over by
``tianshou_tpu_torch.models.convert``), and every random draw is the JAX
key's own (``jax.random.normal`` of the key the JAX function splits), handed
to the port's ``from_noise``.

Tolerances:
- net outputs: rtol 1e-5, atol 1e-6 (the same float32 sums in another order);
- log-probabilities: atol 1e-5 (a sum of six terms of up to ~20 each);
- ``polyak_update``: bit-identical to ``optax.incremental_update`` run op by
  op (both round ``tau * online`` and ``(1 - tau) * target`` to float32 and
  add them); under ``jax.jit`` XLA on the CPU contracts ``tau * online`` and
  the sum into one fused multiply-add (1,021 of 100,000 values differ at tau
  0.005), so there the port is within one float32 ulp of the larger of the
  two products and the result;
- the initial weights' std per ensemble member: within 3% of flax's
  ``1/sqrt(K*I)`` and of the std flax draws (65,536 draws per member).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.exploration import noise as jnoise
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu.models import distributions as jdist
from tianshou_tpu.models.mlp import EnsembleLinear as JEnsembleLinear
from tianshou_tpu_torch.algorithm.base import polyak_update
from tianshou_tpu_torch.exploration.noise import GaussianNoise, OUNoise
from tianshou_tpu_torch.models import continuous
from tianshou_tpu_torch.models.convert import (
    continuous_actor_det_params_from_flax,
    continuous_actor_prob_params_from_flax,
    continuous_critic_params_from_flax,
    ensemble_critic_params_from_flax,
)
from tianshou_tpu_torch.models.distributions import TanhNormal
from tianshou_tpu_torch.models.mlp import EnsembleLinear

NET = dict(rtol=1e-5, atol=1e-6)
LOGP = dict(rtol=0, atol=1e-5)
OBS, ACT, B, HID = 11, 4, 12, (24, 16)


def t(x):
    return torch.from_numpy(np.array(x))


def npy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def obs():
    return np.random.default_rng(0).standard_normal((B, OBS)).astype(np.float32)


def _loc_scale(seed=1, shape=(B, ACT)):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.5, shape).astype(np.float32), np.exp(rng.uniform(-3, 1, shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# TanhNormal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2])
def test_tanh_normal_sample_and_log_prob_from_handed_draws(seed):
    loc, scale = _loc_scale(seed)
    key = jax.random.key(seed)
    want_a, want_logp = jdist.TanhNormal(jnp.asarray(loc), jnp.asarray(scale)).sample_and_log_prob(key)
    eps = np.asarray(jax.random.normal(key, loc.shape, jnp.float32))
    dist = TanhNormal(t(loc), t(scale))
    got_a, got_logp = dist.from_noise(t(eps))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **NET)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), **LOGP)
    assert got_a.shape == (B, ACT) and got_logp.shape == (B,)
    # the generator route draws standard normals of loc's shape and squashes them the same way
    a, logp = dist.sample_and_log_prob(torch.Generator().manual_seed(3))
    a2, logp2 = dist.from_noise(torch.randn(loc.shape, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(a, a2) and torch.equal(logp, logp2) and torch.equal(dist.sample(torch.Generator().manual_seed(3)), a)


def test_tanh_normal_log_prob_near_the_bounds_and_mode():
    loc, scale = _loc_scale(4, (6, 3))
    act = np.array([[1.0, -1.0, 0.9999999], [-0.9999999, 0.0, 0.5], [0.999, -0.999, 0.25],
                    [1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [0.3, -0.7, 0.99999]], dtype=np.float32)
    jd = jdist.TanhNormal(jnp.asarray(loc), jnp.asarray(scale))
    dist = TanhNormal(t(loc), t(scale))
    got, want = dist.log_prob(t(act)).numpy(), np.asarray(jd.log_prob(jnp.asarray(act)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGP)
    np.testing.assert_allclose(dist.mode().numpy(), np.asarray(jd.mode()), **NET)
    # the log-prob of a sample is the one sample_and_log_prob reports
    a, logp = dist.from_noise(torch.full(loc.shape, 0.3))
    np.testing.assert_allclose(dist.log_prob(a).numpy(), logp.numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# actors and critics
# ---------------------------------------------------------------------------
def test_deterministic_actor_matches_jax(obs):
    m = jcont.ContinuousActorDeterministic(HID, ACT, max_action=2.0)
    p = m.init(jax.random.key(0), jnp.asarray(obs))
    net = continuous.ContinuousActorDeterministic(HID, ACT, max_action=2.0, input_dim=OBS)
    net.load_state_dict(continuous_actor_det_params_from_flax(npy(p)))
    for x in (obs, obs * 50.0):  # 50x saturates the tanh
        with torch.no_grad():
            got = net(t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(m.apply(p, jnp.asarray(x))), **NET)
        assert np.abs(got).max() <= 2.0
    assert np.abs(got).max() == pytest.approx(2.0, abs=1e-3)


def test_probabilistic_actor_with_conditioned_sigma_and_its_clip(obs):
    m = jcont.ContinuousActorProbabilistic(HID, ACT, conditioned_sigma=True)
    p = m.init(jax.random.key(1), jnp.asarray(obs))
    net = continuous.ContinuousActorProbabilistic(HID, ACT, conditioned_sigma=True, input_dim=OBS)
    net.load_state_dict(continuous_actor_prob_params_from_flax(npy(p)))
    extreme = obs * np.float32(400.0)  # drives log-sigma past both ends of [-20, 2]
    for x in (obs, extreme):
        want_mu, want_sigma = m.apply(p, jnp.asarray(x))
        with torch.no_grad():
            mu, sigma = net(t(x))
        np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), **NET)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), **NET)
    log_sigma = np.log(sigma.numpy())
    assert np.isclose(log_sigma, 2.0, atol=1e-6).any() and np.isclose(log_sigma, -20.0, atol=1e-5).any()


@pytest.mark.parametrize("k,ensemble_input", [(5, False), (3, True)])
def test_ensemble_linear_matches_jax(k, ensemble_input):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((k, B, 9) if ensemble_input else (B, 9)).astype(np.float32)
    m = JEnsembleLinear(k, 7)
    p = m.init(jax.random.key(k), jnp.asarray(x))
    kernel, bias = npy(p)["params"]["kernel"], rng.standard_normal((k, 1, 7)).astype(np.float32)
    want = np.asarray(m.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    layer = EnsembleLinear(k, 9, 7)
    assert layer.weight.shape == kernel.shape and layer.bias.shape == bias.shape
    layer.load_state_dict({"weight": t(kernel), "bias": t(bias)})
    with torch.no_grad():
        got = layer(t(x)).numpy()
    assert got.shape == (k, B, 7)
    np.testing.assert_allclose(got, want, **NET)


def test_ensemble_linear_initial_std_per_member_is_flaxs():
    """flax's LeCun normal on a ``[K, I, O]`` kernel counts K into the fan-in: std ``1/sqrt(K*I)``."""
    k, i, o = 10, 256, 256
    want = 1.0 / np.sqrt(k * i)
    jw = np.asarray(JEnsembleLinear(k, o).init(jax.random.key(0), jnp.zeros((2, i)))["params"]["kernel"])
    torch.manual_seed(0)
    layer = EnsembleLinear(k, i, o)
    tw = layer.weight.detach().numpy()
    j_std, t_std = jw.reshape(k, -1).std(1), tw.reshape(k, -1).std(1)
    np.testing.assert_allclose(j_std, want, rtol=0.03)
    np.testing.assert_allclose(t_std, want, rtol=0.03)
    np.testing.assert_allclose(t_std, j_std, rtol=0.03)
    assert np.abs(tw).max() <= 2 * want / 0.87962566103423978 + 1e-6  # truncated at two stds of the normal
    assert not layer.bias.detach().any()


def test_ensemble_critic_matches_jax(obs):
    act = np.random.default_rng(5).uniform(-1, 1, (B, ACT)).astype(np.float32)
    m = jcont.EnsembleCritic(ensemble_size=6, hidden_sizes=HID)
    p = m.init(jax.random.key(2), jnp.asarray(obs), jnp.asarray(act))
    net = continuous.EnsembleCritic(6, HID, input_dim=OBS, action_dim=ACT)
    net.load_state_dict(ensemble_critic_params_from_flax(npy(p)))
    with torch.no_grad():
        got = net(t(obs), t(act)).numpy()
    assert got.shape == (6, B)
    np.testing.assert_allclose(got, np.asarray(m.apply(p, jnp.asarray(obs), jnp.asarray(act))), **NET)
    assert np.ptp(got, axis=0).min() > 0  # the members differ


def test_continuous_critic_with_action_and_reset_parameters(obs):
    act = np.random.default_rng(6).uniform(-1, 1, (B, ACT)).astype(np.float32)
    m = jcont.ContinuousCritic(HID)
    p = m.init(jax.random.key(3), jnp.asarray(obs), jnp.asarray(act))
    net = continuous.ContinuousCritic(HID, input_dim=OBS, action_dim=ACT)
    net.load_state_dict(continuous_critic_params_from_flax(npy(p)))
    with torch.no_grad():
        got = net(t(obs), t(act)).numpy()
    np.testing.assert_allclose(got, np.asarray(m.apply(p, jnp.asarray(obs), jnp.asarray(act))), **NET)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.reset_parameters()
    for k, v in net.state_dict().items():
        if k.endswith("bias"):
            assert not v.any(), k
        else:
            assert not torch.equal(v, before[k]) and v.std() == pytest.approx(1 / np.sqrt(v.shape[1]), rel=0.25), k


# ---------------------------------------------------------------------------
# exploration noise and polyak averaging
# ---------------------------------------------------------------------------
def test_gaussian_noise_matches_jax():
    key, shape = jax.random.key(7), (5, 3)
    eps = np.asarray(jax.random.normal(key, shape))
    for mu, sigma in ((0.0, 0.1), (0.5, 2.0)):
        want = np.asarray(jnoise.GaussianNoise(mu, sigma).sample(key, shape))
        np.testing.assert_allclose(GaussianNoise(mu, sigma).from_noise(t(eps)).numpy(), want, **NET)
    n = GaussianNoise(sigma=0.1)
    got = n.sample(torch.Generator().manual_seed(0), shape)
    assert torch.equal(got, n.from_noise(torch.randn(shape, generator=torch.Generator().manual_seed(0))))


def test_ou_noise_matches_jax():
    jn, tn = jnoise.OUNoise(sigma=0.3, theta=0.15, dt=1e-2, x0=0.2), OUNoise(sigma=0.3, theta=0.15, dt=1e-2, x0=0.2)
    jx, tx = jn.init((4, 2)), tn.init((4, 2), device="cpu")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for i in range(5):  # a carried state over five steps
        key = jax.random.key(10 + i)
        jx = jn.step(jx, key)
        tx = tn.step_from_noise(tx, t(jax.random.normal(key, (4, 2))))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **NET)
    key = jax.random.key(20)
    np.testing.assert_allclose(tn.from_noise(t(jax.random.normal(key, (3,)))).numpy(),
                               np.asarray(jn.sample(key, (3,))), **NET)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    assert torch.equal(tn.step(tx, g1), tn.step_from_noise(tx, torch.randn(tx.shape, generator=g2)))


def test_noise_entry_points_default_to_the_card():
    """With no device, ``sample`` draws on the generator's device and ``OUNoise.init`` asks for the card."""
    g = torch.Generator().manual_seed(3)
    for noise in (GaussianNoise(sigma=0.1), OUNoise()):
        assert noise.sample(g, (2, 3)).device == g.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OUNoise().init((2,))
    else:
        assert OUNoise().init((2,)).device.type == "cuda"
    assert OUNoise(x0=0.5).init((2,), device="cpu").eq(0.5).all()


@pytest.mark.parametrize("tau", [0.005, 0.3, 1.0])
def test_polyak_update_matches_optax_incremental_update(tau):
    rng = np.random.default_rng(8)
    shapes = [(24, 11), (24,), (1,), ()]
    online = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    target = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = optax.incremental_update([jnp.asarray(x) for x in online], [jnp.asarray(x) for x in target], tau)
    jitted = jax.jit(lambda o, tg: optax.incremental_update(o, tg, tau))(online, target)
    got = [t(x) for x in target]
    before = [g.data_ptr() for g in got]
    polyak_update(got, [t(x) for x in online], tau)
    assert [g.data_ptr() for g in got] == before  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, o, tg, j in zip(got, online, target, jitted):
        larger = np.maximum(np.abs(np.float32(tau) * o), np.abs(np.float32(1.0 - tau) * tg))
        larger = np.maximum(larger, np.abs(np.asarray(j)))
        assert (np.abs(g.numpy() - np.asarray(j)) <= np.spacing(larger)).all()
