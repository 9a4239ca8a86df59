"""The port's feed-forward nets (``tianshou_tpu_torch.models.mlp``) against
the flax ones, and one DQN update over ``Net`` on CartPole-shaped batches
against the JAX package.

- ``MLP``, ``Net`` (with ``num_atoms``, ``softmax``, ``concat_action`` and
  ``norm="layer"``) and ``DuelingNet``: the same inputs through flax and,
  with the weights carried over by ``net_params_from_flax``, through torch,
  at atol 1e-5 (float32 matmuls summed in another order).
- One update of ``DQN(Net((64, 64), 2))`` (n-step 3, gamma 0.97, target
  net) on the same sampled rows: n-step returns, loss, TD error and Q mean at
  rtol 1e-4 / atol 1e-5, parameters after one Adam step at atol 2e-5 for
  every weight and 2e-6 for 99.9% of each tensor, the tolerance of
  ``tests/test_torch_dqn.py``.
- A fresh net's initial weights follow flax's defaults: zero biases, kernels
  from a normal truncated at two standard deviations of 1/sqrt(fan_in)/0.8796.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import mlp as jmlp
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models import mlp
from tianshou_tpu_torch.models.convert import net_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
B, D = 16, 6

# (name, flax module, its torch counterpart, takes an action)
CASES = [
    ("mlp_hidden_out", jmlp.MLP((32, 16)), lambda: mlp.MLP(D, (32, 16)), False),
    ("mlp_head", jmlp.MLP((24,), 5), lambda: mlp.MLP(D, (24,), 5), False),
    ("net", jmlp.Net((64, 64), 3), lambda: mlp.Net((64, 64), 3, input_dim=D), False),
    ("net_atoms_softmax", jmlp.Net((32,), 3, num_atoms=7, softmax=True),
     lambda: mlp.Net((32,), 3, num_atoms=7, softmax=True, input_dim=D), False),
    ("net_layer_norm", jmlp.Net((32, 32), 2, norm="layer"), lambda: mlp.Net((32, 32), 2, norm="layer", input_dim=D), False),
    ("net_critic", jmlp.Net((32, 32), 1, concat_action=True),
     lambda: mlp.Net((32, 32), 1, concat_action=True, input_dim=D, action_dim=2), True),
    ("net_features", jmlp.Net((32,)), lambda: mlp.Net((32,), input_dim=D), False),
    ("dueling", jmlp.DuelingNet((32,), 4, dueling_hidden=(16,)),
     lambda: mlp.DuelingNet((32,), 4, dueling_hidden=(16,), input_dim=D), False),
    ("dueling_atoms", jmlp.DuelingNet((32, 32), 3, num_atoms=5), lambda: mlp.DuelingNet((32, 32), 3, num_atoms=5, input_dim=D), False),
]


@pytest.mark.parametrize("name,jnet,make,critic", CASES, ids=[c[0] for c in CASES])
def test_net_matches_flax(name, jnet, make, critic):
    rng = np.random.default_rng(len(name))
    obs = rng.standard_normal((B, D)).astype(np.float32)
    act = rng.standard_normal((B, 2)).astype(np.float32)
    args = (jnp.asarray(obs), jnp.asarray(act)) if critic else (jnp.asarray(obs),)
    params = jnet.init(jax.random.key(1), *args)
    # perturb the LayerNorm scales and biases away from 1 and 0, so that their carry-over is checked
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(jax.random.key(len(path)), v.shape)
        if any("LayerNorm" in str(k) for k in path) or "bias" in str(path[-1]) else v, params)
    want = np.asarray(jnet.apply(params, *args))
    net = make()
    net.load_state_dict(net_params_from_flax(jax.tree.map(np.asarray, params)))
    targs = (torch.from_numpy(obs), torch.from_numpy(act)) if critic else (torch.from_numpy(obs),)
    got = net(*targs).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_follows_flax_defaults():
    torch.manual_seed(0)
    net = mlp.Net((256, 256), 2, input_dim=64)
    for layer in net.mlp.linears:
        fan_in = layer.weight.shape[1]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = layer.weight.detach()
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert abs(float(w.std()) - math.sqrt(1.0 / fan_in)) < 0.1 * math.sqrt(1.0 / fan_in)
        assert float(layer.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="norm"):
        mlp.MLP(4, (8,), norm="batch")


def _flat(sd):
    return {k: v.detach().clone().numpy() for k, v in sd.items()}


def test_one_dqn_update_over_net_matches_jax():
    rng = np.random.default_rng(0)
    kw = dict(gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
    jalgo = JDQN(model=jmlp.Net((64, 64), 2), action_space=jcore.Discrete(2), optim=JAdam(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(4))
    net = mlp.Net((64, 64), 2, input_dim=4)
    net.load_state_dict(net_params_from_flax(jax.tree.map(np.asarray, jts.params["model"])))
    talgo = DQN(model=net, action_space=tcore.Discrete(2), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    tts = talgo.init("cpu")
    before = _flat(tts.model.state_dict())

    E, C = 4, 16
    ex = dict(obs=np.zeros(4, np.float32), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False), obs_next=np.zeros(4, np.float32))
    jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    for _ in range(13):
        step = dict(obs=rng.uniform(-0.2, 0.2, (E, 4)).astype(np.float32), act=rng.integers(0, 2, E).astype(np.int32),
                    rew=np.ones(E, np.float32), terminated=rng.random(E) < 0.1, truncated=rng.random(E) < 0.05,
                    obs_next=rng.uniform(-0.2, 0.2, (E, 4)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    idx = rng.integers(0, E, 64) * C + rng.integers(0, 13, 64)  # written slots only

    jbatch = jb.get(js, jnp.asarray(idx), drop_keys=jalgo.update_sample_drop_keys)
    jbatch = jalgo.preprocess(jts, jb, js, jbatch, jnp.asarray(idx), jax.random.key(1))
    jts2, jstats = jalgo.update_step(jts, jbatch, jax.random.key(1))
    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys)
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    tts, tstats = talgo.update_step(tts, tbatch)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    np.testing.assert_allclose(tstats.q_mean.item(), float(jstats.q_mean), **TOL)
    want = net_params_from_flax(jax.tree.map(np.asarray, jts2.params["model"]))
    got = _flat(tts.model.state_dict())
    for k, w in want.items():
        assert not np.array_equal(got[k], before[k]), k
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k
