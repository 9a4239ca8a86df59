"""Acrobot, MountainCar and MountainCarContinuous in the port
(``tianshou_tpu_torch.env.classic``) against the JAX package's, vmapped over
the same states and actions.

- One step from 256 states (near the velocity clips, the wrap at +-pi, the
  left wall, the goal and truncation): MountainCar's state, observation and
  reward at rtol = atol = 1e-6 (XLA's and PyTorch's float32 ``cos`` may
  differ by an ulp); Acrobot's RK4 step, four evaluations of the dynamics
  with divisions by ``d1``, at rtol = atol = 1e-5 (angles compared modulo
  2 pi, so that a wrap on either side of pi is the same angle); ``t``
  exactly; ``terminated`` / ``truncated`` and Acrobot's reward exactly
  except where the termination quantity lies within 1e-5 of its threshold.
- Reset from JAX's draw: the uniforms ``jax.random.uniform(key, shape)``
  of each env's reset key, handed to ``reset_from``, give the JAX reset's
  state to 1e-7 (``minval + u * (maxval - minval)``, which XLA may fuse);
  ``t`` 0, the velocity 0 for MountainCar.
- The spaces (shape, bounds, ``n``) and ``max_episode_steps`` exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.classic import acrobot as jac
from tianshou_tpu.env.classic import mountain_car as jmc
from tianshou_tpu_torch.env.classic import acrobot as tac
from tianshou_tpu_torch.env.classic import mountain_car as tmc
from tianshou_tpu_torch.env.core import Box, Discrete, VectorDeviceEnv
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

N = 256
EDGE = 1e-5


def _step_both(jenv, tenv, jstate_cls, tstate_cls, cols, act, act_dtype):
    js = jstate_cls(*(jnp.asarray(c) for c in cols))
    ts = tstate_cls(*(torch.from_numpy(c) for c in cols))
    jout = jax.vmap(jenv.step)(js, jnp.asarray(act), jax.random.split(jax.random.key(0), N))
    tout = tenv.step(ts, torch.from_numpy(act).to(act_dtype), torch.Generator())
    return jout, tout


def _angle_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.mark.parametrize("seed", [0, 1])
def test_acrobot_step_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jenv, tenv = jac.Acrobot(max_episode_steps=100), tac.Acrobot(max_episode_steps=100)
    th1 = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    th2 = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    th1[:16] = np.float32(np.pi) * rng.choice([-1, 1], 16) * np.float32(1 - 1e-3)  # near the wrap
    d1 = rng.uniform(-4 * np.pi, 4 * np.pi, N).astype(np.float32)
    d2 = rng.uniform(-9 * np.pi, 9 * np.pi, N).astype(np.float32)
    d1[16:32] = np.float32(4 * np.pi) * rng.choice([-1, 1], 16)  # at the clips
    d2[32:48] = np.float32(9 * np.pi) * rng.choice([-1, 1], 16)
    t = rng.integers(0, 100, N).astype(np.int32)
    t[48:64] = 99  # truncated by this step unless terminated
    act = rng.integers(0, 3, N).astype(np.int32)
    jout, tout = _step_both(jenv, tenv, jac.AcrobotState, tac.AcrobotState, (th1, th2, d1, d2, t), act, torch.int64)
    tol = dict(rtol=1e-5, atol=1e-5)
    for name, a, b in zip(tac.AcrobotState._fields, tout.state, jout.state):
        a, b = a.numpy(), np.asarray(b)
        if name == "t":
            np.testing.assert_array_equal(a, b)
        elif name.startswith("theta"):
            assert a.dtype == np.float32 and float(_angle_diff(a, b).max()) <= 1e-5, name
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=name)
    assert tout.obs.shape == (N, 6) and tout.obs.dtype == torch.float32
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), **tol)
    jt1, jt2 = np.asarray(jout.state.theta1), np.asarray(jout.state.theta2)
    clear = np.abs(-np.cos(jt1) - np.cos(jt2 + jt1) - 1.0) > EDGE
    assert clear.sum() >= N - 4
    for k in ("terminated", "truncated", "reward"):
        a, b = getattr(tout, k).numpy(), np.asarray(getattr(jout, k))
        np.testing.assert_array_equal(a[clear], b[clear], err_msg=k)
    assert np.asarray(jout.truncated).any()


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_mountain_car_step_matches_jax(continuous):
    rng = np.random.default_rng(3)
    jenv = jmc.MountainCarContinuous(50) if continuous else jmc.MountainCar(50)
    tenv = tmc.MountainCarContinuous(50) if continuous else tmc.MountainCar(50)
    pos = rng.uniform(-1.2, 0.6, N).astype(np.float32)
    vel = rng.uniform(-0.07, 0.07, N).astype(np.float32)
    pos[:16], vel[:16] = np.float32(-1.2), -np.abs(vel[:16])  # at the left wall, moving left
    goal = 0.45 if continuous else 0.5
    pos[16:32] = np.float32(goal) - rng.uniform(0.0, 0.05, 16).astype(np.float32)  # about to reach the goal
    vel[16:32] = np.float32(0.07)
    vel[32:48] = np.float32(0.07) * rng.choice([-1, 1], 16)  # at the speed clip
    t = rng.integers(0, 50, N).astype(np.int32)
    t[48:64] = 49
    if continuous:
        act, dtype = rng.uniform(-1.5, 1.5, (N, 1)).astype(np.float32), torch.float32
    else:
        act, dtype = rng.integers(0, 3, N).astype(np.int32), torch.int64
    jout, tout = _step_both(jenv, tenv, jmc.MountainCarState, tmc.MountainCarState, (pos, vel, t), act, dtype)
    tol = dict(rtol=1e-6, atol=1e-6)
    for name, a, b in zip(tmc.MountainCarState._fields, tout.state, jout.state):
        if name == "t":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol, err_msg=name)
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), **tol)
    assert tout.obs.shape == (N, 2) and tout.reward.dtype == torch.float32 and tout.reward.shape == (N,)
    np.testing.assert_allclose(tout.reward.numpy(), np.broadcast_to(np.asarray(jout.reward), (N,)), **tol)
    clear = np.abs(np.asarray(jout.state.position) - goal) > EDGE
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(tout, k).numpy()[clear], np.asarray(getattr(jout, k))[clear], err_msg=k)
    assert np.asarray(jout.terminated).any() and np.asarray(jout.truncated).any()
    at_wall = tout.state.position == np.float32(-1.2)
    assert bool(at_wall.any()) and bool((tout.state.velocity[at_wall] >= 0).all())  # stopped at the wall


@pytest.mark.parametrize("name", ["acrobot", "mountain_car", "mountain_car_continuous"])
def test_reset_from_jax_draws(name):
    jenv, tenv, width = {
        "acrobot": (jac.Acrobot(), tac.Acrobot(), 4),
        "mountain_car": (jmc.MountainCar(), tmc.MountainCar(), 0),
        "mountain_car_continuous": (jmc.MountainCarContinuous(), tmc.MountainCarContinuous(), 0),
    }[name]
    keys = jax.random.split(jax.random.key(11), N)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (width,) if width else ()))(keys)
    tstate, tobs = tenv.reset_from(torch.from_numpy(np.asarray(u)))
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-7)
    assert int(tstate.t.abs().max()) == 0
    if width == 0:
        assert float(tstate.velocity.abs().max()) == 0.0
        assert float(tstate.position.min()) >= -0.6 and float(tstate.position.max()) < -0.4
    # the generator path draws in the same interval
    state, _ = tenv.reset(4096, torch.Generator().manual_seed(0), "cpu")
    first = state[0]
    assert float(first.std()) > 0.02


@pytest.mark.parametrize("name", ["Acrobot", "MountainCar", "MountainCarContinuous"])
def test_spaces_and_truncation_match_jax(name):
    jmod, tmod = (jac, tac) if name == "Acrobot" else (jmc, tmc)
    jenv, tenv = getattr(jmod, name)(), getattr(tmod, name)()
    assert tenv.max_episode_steps == jenv.max_episode_steps
    for attr in ("observation_space", "action_space"):
        js, ts = getattr(jenv, attr), getattr(tenv, attr)
        assert type(ts).__name__ == type(js).__name__ and ts.shape == js.shape, attr
        if isinstance(ts, Box):
            np.testing.assert_array_equal(ts.low_arr, js.low_arr)
            np.testing.assert_array_equal(ts.high_arr, js.high_arr)
        else:
            assert isinstance(ts, Discrete) and ts.n == js.n
    venv = VectorDeviceEnv(getattr(tmod, name)(max_episode_steps=5), 3, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, _ = venv.reset(g)
    act = venv.action_space.sample(3, g, "cpu")
    for step in range(1, 6):
        out = venv.step(state, act, g)
        state = out.state
        assert bool((out.truncated | out.terminated).all()) == (step == 5) or bool(out.terminated.any())
    assert int(state.t.max()) == 5 and math.isfinite(float(out.obs.abs().max()))
