"""The slice as a whole: DQN on frame-stacked uint8 pixels in the port
(tianshou_tpu_torch) against the JAX package (tianshou_tpu).

- One update: both buffers hold the same transitions, both DQNs hold the same
  float32 NatureCNN+Dense weights, and ``preprocess`` + ``update_step`` run
  on the same sampled indices. The n-step returns, loss and TD error agree to
  rtol 1e-4 / atol 1e-5 (float32 convolutions summed in another order). The
  parameters after one Adam step (lr 1e-3) agree to atol 2e-6 (0.2% of a
  step) for at least 99.9% of the weights and to atol 2e-5 for all: Adam's
  first step is ``lr * g / (|g| + 1e-8)``, so a weight whose gradient is
  near 1e-8 moves by a share of lr set by the last bits of that gradient.
- The target net syncs on the same gradient steps as in JAX.
- A collector rollout (eps 0) over a deterministic pixel env defined here in
  both frameworks, with episodes that end at a fixed step, stores
  bit-identical uint8 rings.
"""

from typing import NamedTuple

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
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env.wrappers import FrameStack as JFrameStack
from tianshou_tpu.env.wrappers import FrameStackState as JFSState
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.wrappers import FrameStack, FrameStackState
from tianshou_tpu_torch.models.atari import DQNet
from tianshou_tpu_torch.models.convert import dqnet_params_from_flax
from tianshou_tpu_torch.ops.kernels import gather
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

A, HW, FEAT, E, STACK = 4, 36, 32, 3, 4
TOL = dict(rtol=1e-4, atol=1e-5)


class JNet(fnn.Module):
    """float32 NatureCNN + Dense head, the JAX side of the test model."""

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(A)(JNatureCNN(FEAT, jnp.float32)(x))


def _tnet():
    return DQNet(A, features=FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _algos(n_step=3, target_update_freq=2, **extra):
    kw = dict(gamma=0.9, n_step_return_horizon=n_step, target_update_freq=target_update_freq, **extra)
    jalgo = JDQN(model=JNet(), action_space=jcore.Discrete(A), optim=JAdam(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((STACK, HW, HW, 1), jnp.uint8))
    net = _tnet()
    net.load_state_dict(dqnet_params_from_flax(_np_tree(jts.params["model"])))
    talgo = DQN(model=net, action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return jalgo, jts, talgo, talgo.init("cpu")


def _example(jax_side):
    # the collector's key order: JAX's Batch pytree matches keys in order
    ex = dict(obs=np.zeros((HW, HW, 1), np.uint8), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros((HW, HW, 1), np.uint8))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def _buffers(C=8):
    kw = dict(stack_num=STACK, save_only_last_obs=True)
    jb, tb = JVRB(E * C, E, **kw), VectorReplayBuffer(E * C, E, **kw)
    return jb, jb.init(_example(True)), tb, tb.init(_example(False), device="cpu")


@pytest.fixture(scope="module")
def filled():
    rng = np.random.default_rng(0)
    jb, js, tb, ts = _buffers()
    for t in range(13):
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
    idx = rng.integers(0, E * 8, 16)
    return jb, js, tb, ts, idx


def _flat_params(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.mark.parametrize("is_double,huber", [(True, None), (False, None), (True, 0.5)],
                         ids=["double", "single", "double_huber"])
def test_one_dqn_update_matches_jax(filled, is_double, huber):
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos(is_double=is_double, huber_loss_delta=huber)
    assert talgo.update_sample_drop_keys == jalgo.update_sample_drop_keys == ("obs_next",)
    key = jax.random.key(1)
    jbatch = jb.get(js, jnp.asarray(idx), drop_keys=jalgo.update_sample_drop_keys)
    jbatch = jalgo.preprocess(jts, jb, js, jbatch, jnp.asarray(idx), key)
    jts2, jstats = jalgo.update_step(jts, jbatch, key)

    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys)
    np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    tts, tstats = talgo.update_step(tts, tbatch)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    np.testing.assert_allclose(tstats.q_mean.item(), float(jstats.q_mean), **TOL)
    want = dqnet_params_from_flax(_np_tree(jts2.params["model"]))
    got = _flat_params(tts.model.state_dict())
    before = _flat_params(_algos()[3].model.state_dict())
    for k, w in want.items():
        assert not np.array_equal(got[k], before[k]) or np.array_equal(w.numpy(), before[k]), k
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k
    assert tts.step.shape == () and int(tts.step) == int(jts2.step) == 1  # a 0-d device tensor, as in the JAX pytree


def test_target_sync_on_the_same_steps_as_jax(filled):
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos(n_step=1, target_update_freq=2)
    jbatch = jalgo.preprocess(jts, jb, js, jb.get(js, jnp.asarray(idx)), jnp.asarray(idx), jax.random.key(0))
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, torch.from_numpy(idx)), torch.from_numpy(idx),
                              torch.Generator())
    j_synced, t_synced = [], []
    for _ in range(5):
        jts, _ = jalgo.update_step(jts, jbatch, jax.random.key(0))
        tts, _ = talgo.update_step(tts, tbatch)
        j_synced.append(all(bool(jnp.array_equal(a, b)) for a, b in zip(
            jax.tree.leaves(jts.target_params["model"]), jax.tree.leaves(jts.params["model"]))))
        t_synced.append(all(torch.equal(a, b) for a, b in zip(tts.target.parameters(), tts.model.parameters())))
    assert t_synced == j_synced == [False, True, False, True, False]


# ---------------------------------------------------------------------------
# a deterministic pixel env in both frameworks: obs from a position pattern,
# the episode terminates at t == 5
# ---------------------------------------------------------------------------
class PixState(NamedTuple):
    pos: object
    t: object


def _pattern(pos, xp):
    row = xp.arange(HW)[:, None]
    col = xp.arange(HW)[None, :]
    return row * 7 + col * 13 + pos * 3


class JPix(jcore.Env):
    def __init__(self):
        self.observation_space = jcore.Box(0, 255, (HW, HW, 1))
        self.action_space = jcore.Discrete(A)

    def _obs(self, s):
        return (_pattern(s.pos, jnp) % 251).astype(jnp.uint8)[..., None]

    def reset(self, key):
        s = PixState(jnp.int32(0), jnp.int32(0))
        return s, self._obs(s)

    def step(self, s, a, key):
        pos, t = s.pos + a.astype(jnp.int32) + 1, s.t + 1
        ns = PixState(pos, t)
        return jcore.EnvStep(state=ns, obs=self._obs(ns), reward=(a == pos % A).astype(jnp.float32),
                             terminated=t >= 5, truncated=jnp.bool_(False), info=JBatch())


class TPix(tcore.Env):
    def __init__(self):
        self.observation_space = tcore.Box(0, 255, (HW, HW, 1))
        self.action_space = tcore.Discrete(A)

    def _obs(self, s):
        return (_pattern(s.pos[:, None, None], torch) % 251).to(torch.uint8)[..., None]

    def reset(self, num_envs, generator, device):
        z = torch.zeros(num_envs, dtype=torch.int32, device=device)
        s = PixState(z, z.clone())
        return s, self._obs(s)

    def step(self, s, a, generator):
        pos, t = s.pos + a.to(torch.int32) + 1, s.t + 1
        ns = PixState(pos, t)
        return tcore.EnvStep(state=ns, obs=self._obs(ns), reward=(a == pos % A).to(torch.float32),
                             terminated=t >= 5, truncated=torch.zeros_like(t, dtype=torch.bool), info=Batch())


def test_collector_rollout_stores_identical_rings():
    jalgo, jts, talgo, tts = _algos()
    jb, js, tb, ts = _buffers(C=8)
    pos0, t0 = np.array([0, 3, 8], np.int32), np.array([0, 2, 4], np.int32)

    jenv = JFrameStack(JPix(), STACK)
    jcoll = JCollector(jcore.VectorDeviceEnv(jenv, E), jalgo, jb)
    jc = jcoll.reset(jax.random.key(0))
    inner = PixState(jnp.asarray(pos0), jnp.asarray(t0))
    frames = jnp.repeat(jax.vmap(jenv.env._obs)(inner)[:, None], STACK, axis=1)
    jc = jc._replace(env_state=JFSState(inner, frames), obs=frames)

    tenv = FrameStack(TPix(), STACK)
    tcoll = DeviceCollector(tcore.VectorDeviceEnv(tenv, E, device="cpu"), talgo, tb)
    tc = tcoll.reset(torch.Generator())
    tinner = PixState(torch.from_numpy(pos0), torch.from_numpy(t0))
    tframes = tenv.env._obs(tinner)[:, None].repeat_interleave(STACK, dim=1)
    tc = tc._replace(env_state=FrameStackState(tinner, tframes), obs=tframes)
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(frames))

    jc, js, jout = jcoll.collect(jts, jc, js, jax.random.key(1), 12, training=True)
    tc, ts, tout = tcoll.collect(tts, tc, ts, torch.Generator(), 12, training=True)
    for k in ("done", "ep_ret", "ep_len"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert int(np.asarray(jout.done).sum()) >= 3  # auto-reset ran
    for k in js.data.keys():
        np.testing.assert_array_equal(ts.data[k].numpy(), np.asarray(js.data[k]).astype(ts.data[k].numpy().dtype),
                                      err_msg=k)
    for f in ("cursor", "size", "last_idx"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(tc.obs.numpy(), np.asarray(jc.obs))


def test_off_policy_trainer_runs_the_update_cadence_on_cpu():
    torch.manual_seed(0)
    _, _, talgo, tts = _algos(target_update_freq=3)
    talgo.eps_training = 0.1
    tts = talgo.init("cpu")
    _, _, tb, ts = _buffers(C=16)
    coll = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(TPix(), STACK), E, device="cpu"), talgo, tb)
    seen = []

    def train_fn(epoch, env_step):
        seen.append((epoch, env_step))
        return {"eps_training": 0.5}

    params = OffPolicyTrainerParams(max_epochs=2, epoch_num_steps=2 * 4 * E, batch_size=8,
                                    collection_step_num_env_steps=4, update_per_step=0.25, start_steps=4 * E,
                                    train_fn=train_fn, verbose=False)
    gather.reset_launch_count()
    res = OffPolicyTrainer(talgo, coll, None, tb, params).run(tts, ts, torch.Generator().manual_seed(0))
    n_updates = round(0.25 * 4 * E)
    assert res.gradient_step == int(res.train_state.step) == 4 * n_updates
    assert res.env_step == 5 * 4 * E
    assert res.last_chunk_stats.loss.shape == (n_updates,)
    assert bool(torch.isfinite(res.last_chunk_stats.loss).all())
    assert np.isfinite(res.update_stats["loss"])
    assert gather.launch_count() == 0  # CPU tensors take the plain version
    assert int(res.buf_state.size.sum()) == E * 16
    assert seen[0] == (1, 4 * E) and len(seen) == 4
    assert res.train_state.hparams["eps_training"].shape == () and float(res.train_state.hparams["eps_training"]) == 0.5


def test_enable_validation_rejects_nan_rewards(monkeypatch):
    from tianshou_tpu_torch import config

    class NaNPix(TPix):
        def step(self, s, a, generator):
            out = super().step(s, a, generator)
            return out._replace(reward=torch.full_like(out.reward, float("nan")))

    monkeypatch.setattr(config, "ENABLE_VALIDATION", True)
    _, _, talgo, tts = _algos()
    _, _, tb, ts = _buffers()
    coll = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(NaNPix(), STACK), E, device="cpu"), talgo, tb)
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=E, collection_step_num_env_steps=1,
                                    batch_size=4, verbose=False)
    with pytest.raises(ValueError, match="NaN detected"):
        OffPolicyTrainer(talgo, coll, None, tb, params).run(tts, ts, torch.Generator())


def test_clip_by_global_norm_matches_optax():
    import optax

    from tianshou_tpu_torch.algorithm.optim import clip_by_global_norm_

    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):  # clipped, and left alone
        want = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)[0]
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_entry_points_raise_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, talgo, _ = _algos()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talgo.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.VectorDeviceEnv(TPix(), 2)
