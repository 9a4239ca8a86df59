"""The Rainbow slice of the port (tianshou_tpu_torch) against the JAX package
(tianshou_tpu): ``NoisyLinear``, ``C51Net``, ``RainbowAtariNet``, ``C51`` /
``RainbowDQN`` over prioritized replay, and the trainer with PER.

Weights are carried across by ``tianshou_tpu_torch.models.convert``. Noise is
computed from the JAX key by the JAX net's own split chain (four keys, one
per noisy layer, each split into an input and an output key) and handed to
the port as ``(eps_in, eps_out)`` pairs.

Tolerances:
- float32 forwards, the projected target distribution, the loss and the
  per-sample cross-entropy: rtol 1e-4 / atol 1e-5 (the same float32 sums in
  another order; ``jnp.linspace`` and ``torch.linspace`` may differ by an ulp
  in a support atom).
- bf16 trunk (the default): atol 2e-3 on probabilities, as
  ``tests/test_torch_models.py`` holds the bf16 Q values: XLA and PyTorch
  round the bf16 intermediates at different places.
- parameters after one Adam step (lr 1e-3): atol 2e-6 (0.2% of a step) for
  at least 99.9% of each tensor and atol 1e-4 (10% of a step) for all.
  Adam's first step is ``lr * g / (|g| + 1e-8)``, so a weight whose gradient
  is near 1e-8 moves by a share of lr set by the last bits of that gradient;
  behind ReLUs and a softmax cross-entropy a few weights in 10^5 have such
  gradients (one of 36,864 conv weights moved 2.3e-5 apart).
- the sum tree after the priority writeback: rtol 1e-4 (``(ce + eps) ** alpha``
  of cross-entropies that agree to rtol 1e-4).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.c51 import C51 as JC51
from tianshou_tpu.algorithm.modelfree.c51 import RainbowDQN as JRainbowDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models.atari import C51Net as JC51Net
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu.models.atari import RainbowAtariNet as JRainbowAtariNet
from tianshou_tpu.models.discrete import NoisyLinear as JNoisyLinear
from tianshou_tpu_torch.algorithm.modelfree.c51 import C51, RainbowDQN
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer, PrioState
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.wrappers import FrameStack
from tianshou_tpu_torch.models.atari import C51Net, DQNet, RainbowAtariNet
from tianshou_tpu_torch.models.convert import (
    c51net_params_from_flax,
    noisy_linear_params_from_flax,
    rainbow_atari_params_from_flax,
)
from tianshou_tpu_torch.models.discrete import NoisyLinear, factorized_noise
from tianshou_tpu_torch.ops.kernels import gather, sumtree
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

A, HW, FEAT, ATOMS, E, STACK, C = 4, 36, 32, 11, 3, 4, 8
F32 = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _f(e):
    e = np.asarray(e)
    return np.sign(e) * np.sqrt(np.abs(e))


def _layer_noise(key, in_f, out_f):
    """(eps_in, eps_out) as ``NoisyLinear.__call__`` draws them from ``key``."""
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(_f(jax.random.normal(k1, (in_f,)))),
            torch.from_numpy(_f(jax.random.normal(k2, (out_f,)))))


def _rainbow_noise(key, feat=FEAT, atoms=ATOMS, actions=A):
    """The four layers' noise as ``RainbowAtariNet.__call__`` derives it from ``key``."""
    ks = jax.random.split(key, 4)
    dims = [(feat, feat), (feat, atoms), (feat, feat), (feat, actions * atoms)]  # v1, v2, a1, a2
    return [_layer_noise(k, i, o) for k, (i, o) in zip(ks, dims)]


class JC51Net32(fnn.Module):
    """The JAX C51Net with a float32 NatureCNN."""

    action_dim: int
    num_atoms: int
    features: int

    @fnn.compact
    def __call__(self, x):
        logits = fnn.Dense(self.action_dim * self.num_atoms)(JNatureCNN(self.features, jnp.float32)(x))
        return fnn.softmax(logits.reshape(-1, self.action_dim, self.num_atoms), axis=-1)


class JRainbow32(JRainbowAtariNet):
    """The JAX RainbowAtariNet (its own ``__call__``) over a float32 NatureCNN."""

    def setup(self):
        self.trunk = JNatureCNN(self.features, jnp.float32)
        self.v1 = JNoisyLinear(self.features, self.sigma0)
        self.v2 = JNoisyLinear(self.num_atoms, self.sigma0)
        self.a1 = JNoisyLinear(self.features, self.sigma0)
        self.a2 = JNoisyLinear(self.action_dim * self.num_atoms, self.sigma0)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (3, STACK, HW, HW, 1), dtype=np.uint8)


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("noisy", [False, True], ids=["mean", "noisy"])
def test_noisy_linear_matches_jax(noisy):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 13)).astype(np.float32)
    m = JNoisyLinear(7)
    p = m.init(jax.random.key(0), jnp.asarray(x))
    key = jax.random.key(3)
    want = np.asarray(m.apply(p, jnp.asarray(x), noise_key=key if noisy else None))
    layer = NoisyLinear(13, 7)
    layer.load_state_dict(noisy_linear_params_from_flax(_np_tree(p)["params"]))
    # the converter centres the means: flax draws them from [0, 2/sqrt(in))
    bound = 1 / np.sqrt(13)
    mu_w = layer.mu_w.detach()
    assert -bound - 1e-6 <= float(mu_w.min()) < 0 < float(mu_w.max()) <= bound + 1e-6
    with torch.no_grad():
        got = layer(torch.from_numpy(x), _layer_noise(key, 13, 7) if noisy else None)
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_noisy_linear_init_and_generator_noise():
    torch.manual_seed(0)
    layer = NoisyLinear(64, 10, sigma0=0.5)
    bound = 1 / 8
    assert layer.mu_w.shape == layer.sigma_w.shape == (10, 64) and layer.mu_b.shape == layer.sigma_b.shape == (10,)
    assert -bound <= float(layer.mu_w.detach().min()) < 0 < float(layer.mu_w.detach().max()) <= bound
    assert torch.all(layer.sigma_w == 0.5 / 8) and torch.all(layer.sigma_b == 0.5 / 8)
    x = torch.randn(4, 64)
    with torch.no_grad():
        a = layer(x, torch.Generator().manual_seed(5))
        b = layer(x, torch.Generator().manual_seed(5))
        g = torch.Generator().manual_seed(5)
        eps_in, eps_out = factorized_noise(64, g, "cpu"), factorized_noise(10, g, "cpu")
        c = layer(x, (eps_in, eps_out))
        mean = layer(x)
    assert torch.equal(a, b) and torch.equal(a, c) and not torch.equal(a, mean)
    e = torch.randn(64, generator=torch.Generator().manual_seed(5))
    assert torch.equal(eps_in, e.sign() * e.abs().sqrt())


def test_c51net_float32_forward_matches_jax(frames):
    m = JC51Net32(A, ATOMS, FEAT)
    p = m.init(jax.random.key(1), jnp.asarray(frames))
    want = np.asarray(m.apply(p, jnp.asarray(frames)))
    net = C51Net(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
    net.load_state_dict(c51net_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, A, ATOMS)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_c51net_bf16_default_forward_matches_jax():
    x = np.random.default_rng(2).integers(0, 256, (2, STACK, 84, 84, 1), dtype=np.uint8)
    m = JC51Net(6, 51)
    p = m.init(jax.random.key(2), jnp.asarray(x))
    want = np.asarray(m.apply(p, jnp.asarray(x)))
    net = C51Net(6, 51)
    net.load_state_dict(c51net_params_from_flax(_np_tree(p)))  # every key and shape matches
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 51)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("noisy", [False, True], ids=["mean", "noisy"])
def test_rainbow_atari_net_float32_forward_matches_jax(frames, noisy):
    m = JRainbow32(A, ATOMS, FEAT)
    p = m.init(jax.random.key(1), jnp.asarray(frames))
    key = jax.random.key(11)
    want = np.asarray(m.apply(p, jnp.asarray(frames), noise_key=key if noisy else None))
    net = RainbowAtariNet(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
    net.load_state_dict(rainbow_atari_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames), _rainbow_noise(key) if noisy else None).numpy()
    assert got.shape == (3, A, ATOMS)
    np.testing.assert_allclose(got, want, **F32)
    if noisy:
        assert not np.allclose(got, np.asarray(m.apply(p, jnp.asarray(frames))), **F32)


def test_rainbow_atari_net_bf16_default_forward_matches_jax():
    x = np.random.default_rng(3).integers(0, 256, (2, STACK, 84, 84, 1), dtype=np.uint8)
    m = JRainbowAtariNet(6, 51)
    p = m.init(jax.random.key(4), jnp.asarray(x))
    key = jax.random.key(12)
    want = np.asarray(m.apply(p, jnp.asarray(x), noise_key=key))
    net = RainbowAtariNet(6, 51)
    net.load_state_dict(rainbow_atari_params_from_flax(_np_tree(p)))  # every key and shape matches
    with torch.no_grad():
        got = net(torch.from_numpy(x), _rainbow_noise(key, 512, 51, 6))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 51)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_rainbow_atari_net_draws_four_layers_of_noise_from_a_generator(frames):
    torch.manual_seed(0)
    net = RainbowAtariNet(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
    x = torch.from_numpy(frames)
    with torch.no_grad():
        a = net(x, torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(1)
        pairs = [(factorized_noise(i, g, "cpu"), factorized_noise(o, g, "cpu"))
                 for i, o in [(FEAT, FEAT), (FEAT, ATOMS), (FEAT, FEAT), (FEAT, A * ATOMS)]]
        b = net(x, pairs)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# C51 / Rainbow over prioritized replay: one update against JAX
# ---------------------------------------------------------------------------
def _example(jax_side):
    ex = dict(obs=np.zeros((HW, HW, 1), np.uint8), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros((HW, HW, 1), np.uint8))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def _per_buffers():
    kw = dict(alpha=0.6, beta=0.4, stack_num=STACK, save_only_last_obs=True)
    jb, tb = JPVRB(E * C, E, **kw), PrioritizedVectorReplayBuffer(E * C, E, **kw)
    return jb, jb.init(_example(True)), tb, tb.init(_example(False), device="cpu")


@pytest.fixture(scope="module")
def filled():
    """Both PER buffers with the same 13 steps and the same unequal priorities."""
    rng = np.random.default_rng(0)
    jb, js, tb, ts = _per_buffers()
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
    idx = rng.integers(0, E * C, 16)
    return jb, js, tb, ts, idx


def _algos(kind, n_step=3):
    kw = dict(num_atoms=ATOMS, v_min=-2.0, v_max=2.0, gamma=0.9, n_step_return_horizon=n_step,
              target_update_freq=2)
    obs = jnp.zeros((STACK, HW, HW, 1), jnp.uint8)
    if kind == "c51":
        jalgo = JC51(model=JC51Net32(A, ATOMS, FEAT), action_space=jcore.Discrete(A), optim=JAdam(lr=1e-3), **kw)
        jts = jalgo.init(jax.random.key(0), obs)
        net = C51Net(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
        convert, cls = c51net_params_from_flax, C51
    else:
        jalgo = JRainbowDQN(model=JRainbow32(A, ATOMS, FEAT), action_space=jcore.Discrete(A), optim=JAdam(lr=1e-3),
                            **kw)
        jts = jalgo.init(jax.random.key(0), obs)
        net = RainbowAtariNet(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW))
        convert, cls = rainbow_atari_params_from_flax, RainbowDQN
    net.load_state_dict(convert(_np_tree(jts.params["model"])))
    talgo = cls(model=net, action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return jalgo, jts, talgo, talgo.init("cpu"), convert


@pytest.mark.parametrize("kind,n_step", [("c51", 3), ("rainbow", 3), ("rainbow", 1)])
def test_one_distributional_update_over_per_matches_jax(filled, kind, n_step):
    jb, js, tb, ts, idx = filled
    ts = PrioState(ts.base, ts.tree.clone(), ts.max_prio.clone(), ts.min_prio.clone())  # the writeback is in place
    jalgo, jts, talgo, tts, convert = _algos(kind, n_step)
    drop = jalgo.update_sample_drop_keys
    assert talgo.update_sample_drop_keys == drop == (("obs_next",) if n_step > 1 else ())
    np.testing.assert_allclose(talgo.support(torch.device("cpu")).numpy(), np.asarray(jalgo.support), rtol=1e-6, atol=1e-7)
    key = jax.random.key(1)
    jidx = jnp.asarray(idx)
    jbatch = jb.get(js, jidx, drop_keys=drop)
    jbatch.weight = jb.get_weight(js, jidx)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, key))(jts, js, jbatch)
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, key)
    js2 = jalgo.postprocess(jts2, jb, js, jbatch, jidx, jstats)

    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=drop)
    tbatch.weight = tb.get_weight(ts, tidx)
    np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))
    np.testing.assert_allclose(tbatch.weight.numpy(), np.asarray(jbatch.weight), rtol=1e-6)
    assert float(tbatch.weight.min()) < 1.0  # the priorities are unequal, so the weights matter
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    assert tbatch.target_dist.shape == (16, ATOMS)
    np.testing.assert_allclose(tbatch.target_dist.numpy(), np.asarray(jbatch.target_dist), **F32)
    np.testing.assert_allclose(tbatch.target_dist.sum(-1).numpy(), 1.0, rtol=1e-5)
    # the loss forward: the same noise for Rainbow (C51 ignores it)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    tts, tstats = talgo.update_step(tts, tbatch, _rainbow_noise(key) if kind == "rainbow" else None)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **F32)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **F32)
    assert not tstats.td_error.requires_grad and tstats.td_error.shape == (16,)
    want = convert(_np_tree(jts2.params["model"]))
    got = {k: v.detach().numpy() for k, v in tts.model.state_dict().items()}
    assert set(want) == set(got)
    for k, w in want.items():
        assert not np.array_equal(got[k], before[k].numpy()), k  # every tensor trains, the sigmas too
        np.testing.assert_allclose(got[k], w.numpy(), rtol=0, atol=1e-4, err_msg=k)
        assert np.mean(np.abs(got[k] - w.numpy()) <= 2e-6) >= 0.999, k
    assert tts.step.shape == () and int(tts.step) == int(jts2.step) == 1  # a 0-d device tensor, as in the JAX pytree
    # priority writeback: the cross-entropy becomes the new priority
    out = talgo.postprocess(tts, tb, ts, tbatch, tidx, tstats)
    assert out is ts
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js2.tree), rtol=1e-4, atol=0)
    np.testing.assert_allclose(ts.max_prio.item(), float(js2.max_prio), rtol=1e-4)
    np.testing.assert_allclose(ts.min_prio.item(), float(js2.min_prio), rtol=1e-4)


def test_rainbow_noise_only_in_the_loss_forward(filled):
    """Acting and ``preprocess`` use the mean weights; ``update`` draws the
    loss forward's noise from its generator."""
    _, _, tb, ts, idx = filled
    ts = PrioState(ts.base, ts.tree.clone(), ts.max_prio.clone(), ts.min_prio.clone())
    _, _, talgo, tts, _ = _algos("rainbow")
    tidx = torch.from_numpy(idx)
    obs = tb.get(ts, tidx, keys=("obs",)).obs
    with torch.no_grad():
        mean_q = (tts.model(obs) * talgo.support(torch.device("cpu"))).sum(-1)
    out = talgo.forward(tts, obs, torch.Generator().manual_seed(0))
    assert torch.equal(out.info.q, mean_q) and torch.equal(out.act, mean_q.argmax(-1))
    batch = tb.get(ts, tidx, drop_keys=("obs_next",))
    t1 = talgo.preprocess(tts, tb, ts, batch.copy(), tidx, torch.Generator().manual_seed(1)).target_dist
    t2 = talgo.preprocess(tts, tb, ts, batch.copy(), tidx, torch.Generator().manual_seed(2)).target_dist
    assert torch.equal(t1, t2)
    # two updates from the same state with different generators see different noise
    losses = []
    for seed in (1, 1, 2):
        _, _, talgo, tts, _ = _algos("rainbow")
        b = talgo.preprocess(tts, tb, ts, batch.copy(), tidx, torch.Generator())
        losses.append(talgo.update_step(tts, b, torch.Generator().manual_seed(seed))[1].loss.item())
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------------------
# the trainer with prioritized replay, on the CPU
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


@pytest.mark.parametrize("kind", ["dqn", "rainbow"])
def test_off_policy_trainer_with_prioritized_replay_on_cpu(kind):
    torch.manual_seed(0)
    kw = dict(action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9,
              n_step_return_horizon=3, target_update_freq=3, eps_training=0.1)
    if kind == "dqn":
        algo = DQN(model=DQNet(A, features=FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)), **kw)
    else:
        algo = RainbowDQN(model=RainbowAtariNet(A, ATOMS, FEAT, compute_dtype=torch.float32, input_hw=(HW, HW)),
                          num_atoms=ATOMS, v_min=-2.0, v_max=2.0, **kw)
    tts = algo.init("cpu")
    init_params = [p.detach().clone() for p in tts.model.parameters()]
    cap = 16
    tb = PrioritizedVectorReplayBuffer(E * cap, E, alpha=0.6, beta=0.4, stack_num=STACK, save_only_last_obs=True)
    ts = tb.init(_example(False), device="cpu")
    coll = DeviceCollector(tcore.VectorDeviceEnv(FrameStack(TPix(), STACK), E, device="cpu"), algo, tb)
    params = OffPolicyTrainerParams(max_epochs=1, epoch_num_steps=3 * 4 * E, batch_size=8,
                                    collection_step_num_env_steps=4, update_per_step=0.5, start_steps=4 * E,
                                    verbose=False)
    gather.reset_launch_count()
    sumtree.reset_launch_count()
    res = OffPolicyTrainer(algo, coll, None, tb, params).run(tts, ts, torch.Generator().manual_seed(0))
    n_updates = round(0.5 * 4 * E)
    assert res.gradient_step == int(res.train_state.step) == 3 * n_updates
    assert res.buf_state is ts and isinstance(ts, PrioState)
    assert int(ts.base.size.sum()) == E * cap  # 16 steps per env filled the 16-slot rings
    stats = res.last_chunk_stats
    assert stats.loss.shape == (n_updates,) and stats.td_error.shape == (n_updates, 8)
    assert bool(torch.isfinite(stats.loss).all()) and bool(torch.isfinite(stats.td_error).all())
    assert all(bool(torch.isfinite(p).all()) for p in tts.model.parameters())
    assert not all(torch.equal(a, b) for a, b in zip(init_params, tts.model.parameters()))
    assert gather.launch_count() == sumtree.launch_count() == 0  # CPU tensors take the plain versions
    # the tree invariant holds exactly, every stored row has mass, and the priorities moved
    tree, bound = ts.tree, tb.segtree.bound
    assert torch.equal(tree[1:bound], tree[2:2 * bound:2] + tree[3:2 * bound:2])
    assert tree[0].item() == 0.0 and bool((tree[bound:bound + E * cap] > 0).all())
    assert bool((tree[bound + E * cap:] == 0).all())
    assert 0 < ts.min_prio.item() <= ts.max_prio.item() and ts.min_prio.item() < 1.0
    assert tree[bound:bound + E * cap].unique().numel() > 1
    batch, idx = tb.sample(ts, torch.Generator().manual_seed(1), 8)
    assert bool(((batch.weight > 0) & (batch.weight <= 1)).all())
