"""CartPole in the port (``tianshou_tpu_torch.env.classic.cartpole``) against
the JAX package's, vmapped over the same states and actions.

- One step from 64 states (some near the thresholds, some near truncation):
  the state and observation at rtol = atol = 1e-6 (XLA's and PyTorch's
  float32 ``cos``/``sin`` may differ by an ulp), ``t`` and the reward
  exactly, ``terminated``/``truncated`` exactly except where ``|x| - 2.4`` or
  ``|theta| - 12 deg`` lies within 1e-5 of zero after the step.
- Reset draws every coordinate from ``U(-0.05, 0.05)`` and starts ``t`` at 0.
- An episode is truncated at ``max_episode_steps`` exactly, not before.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.classic.cartpole import CartPole as JCartPole
from tianshou_tpu.env.classic.cartpole import CartPoleState as JState
from tianshou_tpu_torch.env.classic.cartpole import CartPole, CartPoleState
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

N = 64
TOL = dict(rtol=1e-6, atol=1e-6)
EDGE = 1e-5
THETA = 12 * 2 * math.pi / 360


def _states(rng, max_steps):
    x = rng.uniform(-2.4, 2.4, N).astype(np.float32)
    x[:8] = np.float32(2.4) * rng.choice([-1, 1], 8) * np.float32(1 - 1e-4)  # at the cart's edge
    x_dot = rng.normal(0, 1.5, N).astype(np.float32)
    theta = rng.uniform(-THETA, THETA, N).astype(np.float32)
    theta[8:16] = np.float32(THETA) * rng.choice([-1, 1], 8) * np.float32(1 - 1e-4)  # at the pole's edge
    theta_dot = rng.normal(0, 2.0, N).astype(np.float32)
    t = rng.integers(0, max_steps, N).astype(np.int32)
    t[16:24] = max_steps - 1  # truncated by this step unless terminated
    return x, x_dot, theta, theta_dot, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jenv, tenv = JCartPole(max_episode_steps=200), CartPole(max_episode_steps=200)
    cols = _states(rng, 200)
    act = rng.integers(0, 2, N).astype(np.int32)
    js = JState(*(jnp.asarray(c) for c in cols))
    ts = CartPoleState(*(torch.from_numpy(c) for c in cols))
    jout = jax.vmap(jenv.step)(js, jnp.asarray(act), jax.random.split(jax.random.key(0), N))
    tout = tenv.step(ts, torch.from_numpy(act).to(torch.int64), torch.Generator())
    for name, a, b in zip(CartPoleState._fields, tout.state, jout.state):
        if name == "t":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), **TOL)
    assert tout.obs.shape == (N, 4) and tout.reward.dtype == torch.float32
    np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward))
    x, theta = np.asarray(jout.state.x), np.asarray(jout.state.theta)
    clear = (np.abs(np.abs(x) - 2.4) > EDGE) & (np.abs(np.abs(theta) - THETA) > EDGE)
    assert clear.sum() >= N - 16
    for k in ("terminated", "truncated"):
        a, b = getattr(tout, k).numpy(), np.asarray(getattr(jout, k))
        np.testing.assert_array_equal(a[clear], b[clear], err_msg=k)
    assert np.asarray(jout.terminated).any() and np.asarray(jout.truncated).any()  # both edges reached


def test_reset_bounds():
    env = CartPole()
    state, obs = env.reset(4096, torch.Generator().manual_seed(3), "cpu")
    for name in ("x", "x_dot", "theta", "theta_dot"):
        v = getattr(state, name)
        assert v.dtype == torch.float32 and v.shape == (4096,)
        assert float(v.min()) >= -0.05 and float(v.max()) <= 0.05
        assert float(v.std()) > 0.02  # spread over the interval, not a constant
    assert state.t.dtype == torch.int32 and int(state.t.abs().max()) == 0
    np.testing.assert_array_equal(obs.numpy(), torch.stack(state[:4], -1).numpy())
    again = env.reset(4096, torch.Generator().manual_seed(3), "cpu")[1]
    assert torch.equal(again, obs)


def test_truncation_at_max_episode_steps():
    venv = VectorDeviceEnv(CartPole(max_episode_steps=7), 3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = venv.reset(gen)
    for step in range(1, 8):
        out = venv.step(state, torch.tensor([0, 1, 0]) if step % 2 else torch.tensor([1, 0, 1]), gen)
        state = out.state
        assert not out.terminated.any()
        assert bool(out.truncated.all()) == (step == 7), step
    assert int(state.t.max()) == 7
