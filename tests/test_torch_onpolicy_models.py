"""The port's distributions and on-policy nets against the JAX package's.

- ``Categorical`` and ``Normal``: ``log_prob``, ``entropy``, ``mode``,
  ``kl_divergence`` and a sample from given noise (the uniforms of
  ``jax.random.categorical``'s Gumbel-max; the normals of ``Normal.sample``),
  at atol 1e-6; a draw from a generator has the right shape, dtype and range.
- ``ContinuousActorProbabilistic`` (plain, ``conditioned_sigma``,
  ``ppo_init``), ``ContinuousCritic`` (with and without the action),
  ``DiscreteActor`` and ``DiscreteCritic``: the same inputs through flax and,
  with the weights carried over by the converters of
  ``tianshou_tpu_torch.models.convert``, through torch, at atol 1e-6.
- ``ppo_init``'s recipe: orthogonal kernels at gain sqrt(2) (the mu head at
  0.01), zero biases, log-sigma at ``sigma_init``; ``sde=True`` is refused.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.models import continuous as jcont
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu.models.distributions import Categorical as JCategorical
from tianshou_tpu.models.distributions import Normal as JNormal
from tianshou_tpu_torch.models import continuous, convert, discrete
from tianshou_tpu_torch.models.distributions import Categorical, Normal
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ATOL = dict(rtol=0, atol=1e-6)
B, D, A = 16, 7, 3


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_categorical_against_jax():
    rng = np.random.default_rng(0)
    logits, other = rng.normal(0, 2, (2, B, A)).astype(np.float32)
    act = rng.integers(0, A, B)
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (B, A)).astype(np.float32)
    jd, jo = JCategorical(jnp.asarray(logits)), JCategorical(jnp.asarray(other))
    td, to = Categorical(t(logits)), Categorical(t(other))
    np.testing.assert_allclose(td.log_prob(t(act)).numpy(), np.asarray(jd.log_prob(jnp.asarray(act))), **ATOL)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), **ATOL)
    np.testing.assert_allclose(td.kl_divergence(to).numpy(), np.asarray(jd.kl_divergence(jo)), **ATOL)
    np.testing.assert_allclose(td.probs.numpy(), np.asarray(jd.probs), **ATOL)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    # jax.random.categorical is argmax(logits + gumbel(u)), gumbel = -log(-log(u))
    want = np.asarray(jnp.argmax(jnp.asarray(logits) - jnp.log(-jnp.log(jnp.asarray(u))), axis=-1))
    np.testing.assert_array_equal(td.from_noise(t(u)).numpy(), want)
    draw = td.sample(torch.Generator().manual_seed(0))
    assert draw.shape == (B,) and draw.dtype == torch.int64 and bool(((draw >= 0) & (draw < A)).all())


def test_categorical_sample_frequencies_follow_the_probabilities():
    logits = torch.tensor([[0.0, 1.0, -1.0]]).expand(20000, 3)
    draws = Categorical(logits).sample(torch.Generator().manual_seed(1))
    freq = torch.bincount(draws, minlength=3).double() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0].double(), 0).numpy(), atol=0.015)


def test_normal_against_jax():
    rng = np.random.default_rng(1)
    loc, loc2, x, eps = rng.normal(0, 1, (4, B, A)).astype(np.float32)
    scale, scale2 = rng.uniform(0.1, 2.0, (2, B, A)).astype(np.float32)
    jd, jo = JNormal(jnp.asarray(loc), jnp.asarray(scale)), JNormal(jnp.asarray(loc2), jnp.asarray(scale2))
    td, to = Normal(t(loc), t(scale)), Normal(t(loc2), t(scale2))
    np.testing.assert_allclose(td.log_prob(t(x)).numpy(), np.asarray(jd.log_prob(jnp.asarray(x))), **ATOL)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), **ATOL)
    np.testing.assert_allclose(td.kl_divergence(to).numpy(), np.asarray(jd.kl_divergence(jo)), **ATOL)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_allclose(td.from_noise(t(eps)).numpy(), loc + scale * eps, **ATOL)
    draw = td.sample(torch.Generator().manual_seed(0))
    assert draw.shape == (B, A) and draw.dtype == torch.float32


# (name, flax module, its torch counterpart, converter, takes an action)
NETS = [
    ("actor_plain", jcont.ContinuousActorProbabilistic((32, 16), A),
     lambda: continuous.ContinuousActorProbabilistic((32, 16), A, input_dim=D),
     convert.continuous_actor_prob_params_from_flax, False),
    ("actor_conditioned", jcont.ContinuousActorProbabilistic((24,), A, conditioned_sigma=True),
     lambda: continuous.ContinuousActorProbabilistic((24,), A, conditioned_sigma=True, input_dim=D),
     convert.continuous_actor_prob_params_from_flax, False),
    ("actor_ppo_init", jcont.ContinuousActorProbabilistic((64, 64), A, ppo_init=True),
     lambda: continuous.ContinuousActorProbabilistic((64, 64), A, ppo_init=True, input_dim=D),
     convert.continuous_actor_prob_params_from_flax, False),
    ("critic_obs", jcont.ContinuousCritic((32, 32), use_action=False),
     lambda: continuous.ContinuousCritic((32, 32), use_action=False, input_dim=D),
     convert.continuous_critic_params_from_flax, False),
    ("critic_obs_act", jcont.ContinuousCritic((32,)),
     lambda: continuous.ContinuousCritic((32,), input_dim=D, action_dim=A),
     convert.continuous_critic_params_from_flax, True),
    ("critic_ppo_init", jcont.ContinuousCritic((64, 64), use_action=False, ppo_init=True),
     lambda: continuous.ContinuousCritic((64, 64), use_action=False, ppo_init=True, input_dim=D),
     convert.continuous_critic_params_from_flax, False),
    ("discrete_actor", jdisc.DiscreteActor((64, 64), A), lambda: discrete.DiscreteActor((64, 64), A, input_dim=D),
     convert.discrete_actor_params_from_flax, False),
    ("discrete_critic", jdisc.DiscreteCritic((64, 64)), lambda: discrete.DiscreteCritic((64, 64), input_dim=D),
     convert.discrete_critic_params_from_flax, False),
]


@pytest.mark.parametrize("name,jnet,make,conv,with_act", NETS, ids=[c[0] for c in NETS])
def test_net_against_flax(name, jnet, make, conv, with_act):
    rng = np.random.default_rng(2)
    obs = rng.normal(0, 1, (B, D)).astype(np.float32)
    act = rng.normal(0, 1, (B, A)).astype(np.float32)
    args = (jnp.asarray(obs), jnp.asarray(act)) if with_act else (jnp.asarray(obs),)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(3), *args))
    if "log_sigma" in params["params"]:  # a non-trivial sigma
        params["params"]["log_sigma"] = rng.normal(0, 0.5, A).astype(np.float32)
    net = make()
    net.load_state_dict(conv(params))
    want = jnet.apply(params, *args)
    with torch.no_grad():
        got = net(t(obs), t(act)) if with_act else net(t(obs))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATOL)


def test_ppo_init_recipe():
    torch.manual_seed(0)
    actor = continuous.ContinuousActorProbabilistic((64, 64), A, ppo_init=True, sigma_init=-0.5, input_dim=D)
    critic = continuous.ContinuousCritic((64, 64), use_action=False, ppo_init=True, input_dim=D)
    for layer, gain in [*((lin, math.sqrt(2.0)) for lin in actor.mlp.linears), (actor.mu, 0.01),
                        *((lin, math.sqrt(2.0)) for lin in critic.mlp.linears)]:
        w = layer.weight.detach().double()
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain**2 * np.eye(small), atol=1e-5)
        assert bool((layer.bias == 0).all())
    np.testing.assert_array_equal(actor.log_sigma.detach().numpy(), np.full(A, -0.5, np.float32))
    assert actor.mlp.activation is torch.tanh and critic.mlp.activation is torch.tanh
    plain = continuous.ContinuousActorProbabilistic((8,), A, input_dim=D)
    assert bool((plain.log_sigma == 0).all())
    # gSDE: a log-sigma matrix [last hidden width, A] at sigma_init, on top of the same PPO init
    sde = continuous.ContinuousActorProbabilistic((64, 32), A, ppo_init=True, sde=True, sigma_init=-2.0, input_dim=D)
    assert sde.log_sigma_mat.shape == (32, A) and not hasattr(sde, "log_sigma")
    np.testing.assert_array_equal(sde.log_sigma_mat.detach().numpy(), np.full((32, A), -2.0, np.float32))
    assert sde.mlp.activation is torch.tanh and bool((sde.mu.bias == 0).all())


def test_sigma_is_clipped():
    actor = continuous.ContinuousActorProbabilistic((8,), A, input_dim=D)
    with torch.no_grad():
        actor.log_sigma.copy_(torch.tensor([-30.0, 0.0, 5.0]))
    _, sigma = actor(torch.zeros(2, D))
    np.testing.assert_allclose(sigma[0].detach().numpy(), np.exp([-20.0, 0.0, 2.0]).astype(np.float32), rtol=1e-6)
