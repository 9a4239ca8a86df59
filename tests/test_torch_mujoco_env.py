"""The port's batched MuJoCo envs against the JAX package's: reset from the
same noise (drawn from the JAX key and handed over) and one step from the same
actions, at the env's own frame_skip (Ant: one substep, to bound the compile)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.mujoco import make as jax_make
from tianshou_tpu_torch.env.core import Box, VectorDeviceEnv
from tianshou_tpu_torch.env.mujoco import REGISTRY, make as torch_make

TASKS = sorted(REGISTRY)
E = 3
OBS_DIM = {"HalfCheetah": 17, "Hopper": 11, "Walker2d": 17, "Ant": 27, "Swimmer": 8, "Reacher": 11}


def make_pair(task, **kw):
    jenv, tenv = jax_make(task, **kw), torch_make(task, **kw)
    if task == "Ant":
        jenv.frame_skip = tenv.frame_skip = 1
        jenv.substeps = tenv.substeps = 1
    return jenv, tenv


def jax_reset_noise(jenv, task, keys):
    """The numbers env.reset(key) draws, per env, in the layout the port's reset_from_noise takes."""
    nq, s = jenv.model.nq, jenv.reset_noise_scale
    out = []
    for key in keys:
        if task == "Reacher":
            k1, k2, k3 = jax.random.split(key, 3)
            out.append((jax.random.uniform(k1, (2,), minval=-0.1, maxval=0.1), jax.random.uniform(k2, (2,)),
                        jax.random.uniform(k3, (nq,), minval=-0.005, maxval=0.005)))
        else:
            k1, k2 = jax.random.split(key)
            dq = jax.random.uniform(k1, (nq,), minval=-s, maxval=s)
            dqd = (s * jax.random.normal(k2, (nq,)) if jenv.reset_noise_kind == "uniform"
                   else jax.random.uniform(k2, (nq,), minval=-s, maxval=s))
            out.append((dq, dqd))
    return tuple(torch.from_numpy(np.stack([np.asarray(o[i]) for o in out])) for i in range(len(out[0])))


@functools.cache
def rolled(task):
    """(JAX reset, JAX step, port reset, port step) from the same noise and actions."""
    jenv, tenv = make_pair(task, max_episode_steps=1)
    keys = jax.random.split(jax.random.key(7), E)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    tstate, tobs = tenv.reset_from_noise(*jax_reset_noise(jenv, task, keys))
    act = np.random.default_rng(0).uniform(-1.3, 1.3, (E, tenv.action_space.shape[0])).astype(np.float32)
    jout = jax.jit(jenv.batch_step)(jstate, jnp.asarray(act), keys)
    tout = tenv.step(tstate, torch.from_numpy(act), torch.Generator().manual_seed(0))
    return (jstate, jobs), jout, (tstate, tobs), tout


@pytest.mark.parametrize("task", TASKS)
def test_reset_from_handed_noise(task):
    (jstate, jobs), _, (tstate, tobs), _ = rolled(task)
    np.testing.assert_allclose(tstate.q.numpy(), np.asarray(jstate.q), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstate.qd.numpy(), np.asarray(jstate.qd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-6)
    assert tobs.shape == (E, OBS_DIM[task]) and tobs.dtype == torch.float32
    assert tstate.t.dtype == torch.int32 and tstate.t.tolist() == [0] * E


@pytest.mark.parametrize("task", TASKS)
def test_step_from_handed_actions(task):
    _, jout, _, tout = rolled(task)
    np.testing.assert_allclose(tout.state.q.numpy(), np.asarray(jout.state.q), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tout.state.qd.numpy(), np.asarray(jout.state.qd), rtol=5e-3, atol=5e-3)
    # observations and rewards are functions of the stepped state: x_vel is a difference over dt
    np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), rtol=5e-3, atol=5e-3)
    assert tout.reward.dtype == torch.float32 and tout.reward.shape == (E,)
    assert tout.terminated.tolist() == np.asarray(jout.terminated).tolist()
    # max_episode_steps = 1: every env that did not terminate is truncated
    assert tout.truncated.tolist() == np.asarray(jout.truncated).tolist() == (~tout.terminated).tolist()
    assert tout.state.t.tolist() == [1] * E


@pytest.mark.parametrize("task", ["Hopper", "Walker2d", "Ant"])
def test_unhealthy_states_terminate(task):
    jenv, tenv = make_pair(task)
    q = np.tile(np.asarray(jenv.model.qpos0, np.float32), (2, 1))
    q[1, 2 if task == "Ant" else 1] = 0.1  # the root far below its healthy height
    qd = np.zeros_like(q)
    want = np.asarray(jax.vmap(jenv._terminated)(q, qd))
    got = tenv._terminated(torch.from_numpy(q), torch.from_numpy(qd))
    assert got.tolist() == want.tolist() == [False, True]


@pytest.mark.parametrize("task", TASKS)
def test_vector_env_takes_random_steps_on_the_cpu(task):
    venv = VectorDeviceEnv(torch_make(task), 4, device="cpu")
    g = torch.Generator().manual_seed(1)
    state, obs = venv.reset(g)
    assert obs.shape == (4, OBS_DIM[task]) == (4, *venv.observation_space.shape)
    for _ in range(3):
        out = venv.step(state, venv.action_space.sample(4, g, venv.device), g)
        state = out.state
    assert state.t.tolist() == [3] * 4
    for x in (state.q, state.qd, out.obs, out.reward):
        assert bool(torch.isfinite(x).all())
    assert not bool(out.truncated.any())


def test_box_sample_stays_inside_its_bounds():
    box = Box(low=[-0.4, 0.0, -2.0], high=[0.4, 1.0, 5.0])
    g = torch.Generator().manual_seed(0)
    x = box.sample(4096, g, torch.device("cpu"))
    low, high = torch.tensor(box.low), torch.tensor(box.high)
    assert x.shape == (4096, 3) and x.dtype == torch.float32
    assert bool((x >= low).all() and (x <= high).all())
    assert bool(((x.mean(0) - (low + high) / 2).abs() < 0.05 * (high - low)).all())  # uniform, not clipped
    assert not torch.equal(x, box.sample(4096, g, torch.device("cpu")))
    with pytest.raises(ValueError, match="finite"):
        torch_make("Hopper").observation_space.sample(1, g, torch.device("cpu"))
    assert torch_make("Swimmer").action_space.sample(2, g, torch.device("cpu")).shape == (2, 2)


def test_make_accepts_gym_suffixes_and_names_unported_tasks():
    assert type(torch_make("HalfCheetah-v4")).__name__ == "HalfCheetah"
    with pytest.raises(KeyError, match="Humanoid"):
        torch_make("Humanoid-v4")
