"""Parity of the port's Atari nets (tianshou_tpu_torch/models/atari.py) with
the JAX package's (tianshou_tpu/models/atari.py), on weights copied by
``tianshou_tpu_torch.models.convert.dqnet_params_from_flax``.

Tolerances:
- float32 compute: rtol 1e-4, atol 1e-5. Both run the same float32
  convolutions; only the summation order differs.
- bf16 compute (the default): atol 2e-3 on Q values of magnitude ~0.2, two
  bf16 steps at that size. XLA and PyTorch round the bf16 intermediates
  (scaled input, each conv and Dense output) at different places, and bf16
  keeps 8 bits of mantissa.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.models.atari import DQNet as JDQNet
from tianshou_tpu.models.atari import NatureCNN as JNatureCNN
from tianshou_tpu_torch.models.atari import DQNet, NatureCNN, same_pads
from tianshou_tpu_torch.models.convert import dqnet_params_from_flax, nature_cnn_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

F32 = dict(rtol=1e-4, atol=1e-5)


class JDQNet32(fnn.Module):
    """The JAX DQNet with a float32 NatureCNN."""

    action_dim: int
    features: int = 512

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.action_dim)(JNatureCNN(self.features, jnp.float32)(x))


def _numpy_tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (3, 4, 84, 84, 1), dtype=np.uint8)


def test_same_padding_matches_flax_widths():
    assert same_pads(84, 8, 4) == (2, 2)
    assert same_pads(21, 4, 2) == (1, 2)  # asymmetric: padding= cannot express it
    assert same_pads(11, 3, 1) == (1, 1)
    assert NatureCNN().fc.in_features == 7744 == 11 * 11 * 64


def test_flatten_width_matches_flax_kernel(frames):
    p = JDQNet(6).init(jax.random.key(0), jnp.asarray(frames))
    assert p["params"]["NatureCNN_0"]["Dense_0"]["kernel"].shape == (7744, 512)
    sd = dqnet_params_from_flax(_numpy_tree(p))
    assert sd["cnn.fc.weight"].shape == (512, 7744)
    DQNet(6).load_state_dict(sd)  # every key and shape matches


def test_dqnet_float32_forward_matches_jax(frames):
    m = JDQNet32(6)
    p = m.init(jax.random.key(1), jnp.asarray(frames))
    want = np.asarray(m.apply(p, jnp.asarray(frames)))
    net = DQNet(6, compute_dtype=torch.float32)
    net.load_state_dict(dqnet_params_from_flax(_numpy_tree(p)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, want, **F32)


def test_dqnet_bf16_default_forward_matches_jax(frames):
    m = JDQNet(6)
    p = m.init(jax.random.key(2), jnp.asarray(frames))
    want = np.asarray(m.apply(p, jnp.asarray(frames)))
    net = DQNet(6)
    net.load_state_dict(dqnet_params_from_flax(_numpy_tree(p)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("layout", ["nhwc", "nchw", "float_nhwc"])
def test_nature_cnn_float32_4d_inputs_match_jax(layout):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 84, 84, 4), dtype=np.uint8)
    if layout == "nchw":
        x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    elif layout == "float_nhwc":
        x = (x / 255.0).astype(np.float32)
    m = JNatureCNN(64, jnp.float32)
    p = m.init(jax.random.key(4), jnp.asarray(x))
    want = np.asarray(m.apply(p, jnp.asarray(x)))
    net = NatureCNN(features=64, compute_dtype=torch.float32)
    net.load_state_dict(nature_cnn_params_from_flax(_numpy_tree(p)["params"]))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, **F32)
