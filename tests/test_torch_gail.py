"""GAIL in the port against the JAX package: one ``update_rollout`` (the
discriminator's steps, the adversarial reward, PPO's passes over the
relabelled rollout) from the same weights, rollout and expert data, with
JAX's draws handed over: the discriminator's expert and policy rows
(``Draws(expert_indices=, policy_indices=)``, the ``randint`` of the two
halves of each step's key) and PPO's minibatches (``perm``, the permutation
its key draws).

Tolerances are ``tests/test_torch_onpolicy.py``'s for PPO's update: the
weights (actor, critic and discriminator) all within 1e-4 and 99.9% of each
tensor within 2e-6; the statistics rtol 1e-4 / atol 1e-4 (means over the
minibatches of float32 losses). Indices and the train state's layout are
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.imitation.gail import GAIL as JGAIL
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import continuous as jcont
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import continuous, discrete
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, A, T, E, N_EXP, DISC_N, REPEAT, BS = 3, 1, 8, 4, 20, 2, 2, 8
N = T * E


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    expert = (rng.standard_normal((N_EXP, OBS)).astype(np.float32),
              rng.uniform(-1, 1, (N_EXP, A)).astype(np.float32))
    term = rng.random((T, E)) < 0.1
    d = dict(obs=rng.standard_normal((T, E, OBS)).astype(np.float32),
             obs_next=rng.standard_normal((T, E, OBS)).astype(np.float32),
             act=rng.normal(0, 0.8, (T, E, A)).astype(np.float32), rew=rng.normal(0.5, 1, (T, E)).astype(np.float32),
             terminated=term, truncated=(rng.random((T, E)) < 0.1) & ~term)
    return expert, JBatch(**{k: jnp.asarray(v) for k, v in d.items()}), Batch(**{k: _t(v) for k, v in d.items()})


def _pair(expert):
    common = dict(gamma=0.95, gae_lambda=0.95, eps_clip=0.2, disc_update_num=DISC_N)
    jalgo = JGAIL(actor=jcont.ContinuousActorProbabilistic((16, 16), A), critic=jdisc.DiscreteCritic((16, 16)),
                  action_space=jcore.Box(-2.0, 2.0, (A,)), optim=JAdam(lr=1e-3, max_grad_norm=0.5),
                  disc_net=jcont.ContinuousCritic((16, 16)), expert_obs=expert[0], expert_act=expert[1],
                  disc_optim=JAdam(lr=1e-2), **common)
    talgo = GAIL(actor=continuous.ContinuousActorProbabilistic((16, 16), A, input_dim=OBS),
                 critic=discrete.DiscreteCritic((16, 16), input_dim=OBS), action_space=tcore.Box(-2.0, 2.0, (A,)),
                 optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5),
                 disc_net=continuous.ContinuousCritic((16, 16), input_dim=OBS, action_dim=A), expert_obs=expert[0],
                 expert_act=expert[1], disc_optim=AdamOptimizerFactory(lr=1e-2), **common)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    params = _np(jts.params)
    params["actor"]["params"]["log_sigma"] = np.full((A,), -0.4, np.float32)  # a sigma other than 1
    jts = jts.replace(params=jax.tree.map(jnp.asarray, params))
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(params, tts.model))
    return jalgo, jts, talgo, tts


def _jax_draws(key):
    """The discriminator's rows and PPO's minibatches that the JAX update draws from ``key``."""
    k_disc, k_ppo, _ = jax.random.split(key, 3)
    expert_idx, policy_idx = [], []
    for k in jax.random.split(k_disc, DISC_N):
        ke, kp = jax.random.split(k)
        expert_idx.append(np.asarray(jax.random.randint(ke, (BS,), 0, N_EXP)))
        policy_idx.append(np.asarray(jax.random.randint(kp, (BS,), 0, N)))
    n_mb = N // BS
    _, k_loop = jax.random.split(k_ppo)
    perm = np.stack([np.asarray(jax.random.permutation(jax.random.split(rk)[0], N))[: n_mb * BS].reshape(n_mb, BS)
                     for rk in jax.random.split(k_loop, REPEAT)])
    return Draws(expert_indices=_t(np.stack(expert_idx)).long(), policy_indices=_t(np.stack(policy_idx)).long()), \
        _t(perm).long()


def _hold(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=k)
        assert np.mean(np.abs(g - w) <= 2e-6) >= 0.999, k


def test_one_gail_update_rollout_matches_jax(data):
    expert, jroll, troll = data
    jalgo, jts, talgo, tts = _pair(expert)
    key = jax.random.key(5)
    jts2, jstats = jalgo.update_rollout(jts, jroll, key, repeat=REPEAT, batch_size=BS)
    draws, perm = _jax_draws(key)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    out_ts, stats = talgo.update_rollout(tts, troll, draws, REPEAT, BS, perm=perm)
    assert out_ts is tts
    _hold(tts.model.state_dict(), actor_critic_params_from_flax(_np(jts2.params), tts.model))
    for k, v in before.items():  # the discriminator and PPO's nets all train
        assert not torch.equal(tts.model.state_dict()[k], v), k
    assert int(tts.step) == int(jts2.step) == REPEAT * (N // BS)
    assert int(tts.optim["disc"].state[next(tts.model["disc"].parameters())]["step"]) == DISC_N
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert troll.rew.equal(_t(np.asarray(jroll.rew)))  # the caller's rollout keeps its reward


def test_gail_train_state_layout_and_device_draws(data):
    """The model holds ``actor``, ``critic`` and ``disc``, the optimizers ``{"ac", "disc"}`` as the JAX
    ``opt_state``; PPO's optimizer steps the actor and critic only. Drawn from a generator, the rows are
    in range and two equal generators give equal updates."""
    expert, _, troll = data
    _, _, talgo, tts = _pair(expert)
    assert list(tts.model.keys()) == ["actor", "critic", "disc"] and set(tts.optim) == {"ac", "disc"}
    ac = {id(p) for g in tts.optim["ac"].param_groups for p in g["params"]}
    assert ac == {id(p) for k in ("actor", "critic") for p in tts.model[k].parameters()}
    assert talgo.rollout_grad_steps(N, REPEAT, BS) == REPEAT * (N // BS)
    g = torch.Generator().manual_seed(3)
    ei = torch.randint(0, N_EXP, (BS,), generator=g)
    assert 0 <= int(ei.min()) and int(ei.max()) < N_EXP
    states = []
    for _ in range(2):
        _, _, talgo, tts = _pair(expert)
        talgo.update_rollout(tts, troll, torch.Generator().manual_seed(3), REPEAT, BS)
        states.append(tts.model.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
