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
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TASKS = sorted(REGISTRY)
E = 3
OBS_DIM = {"HalfCheetah": 17, "Hopper": 11, "Walker2d": 17, "Ant": 27, "Swimmer": 8, "Reacher": 11, "Humanoid": 123}


def make_pair(task, **kw):
    jenv, tenv = jax_make(task, **kw), torch_make(task, **kw)
    if task in ("Ant", "Humanoid"):  # one substep, to bound the JAX compile
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


@pytest.mark.parametrize("task", ["Hopper", "Walker2d", "Ant", "Humanoid"])
def test_unhealthy_states_terminate(task):
    jenv, tenv = make_pair(task)
    q = np.tile(np.asarray(jenv.model.qpos0, np.float32), (2, 1))
    q[1, 2 if task in ("Ant", "Humanoid") else 1] = 0.1  # the root far below its healthy height
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
    # an unbounded box (Hopper's observation space) samples as the JAX package does: a standard normal
    # where a bound is not finite; JAX's two draws of one key are handed over
    space = torch_make("Hopper").observation_space
    key = jax.random.key(0)
    u, n = (np.array(f(key, space.shape)) for f in (jax.random.uniform, jax.random.normal))
    want = np.asarray(jax_make("Hopper").observation_space.sample(key))
    got = space.sample_from(torch.from_numpy(u)[None], torch.from_numpy(n)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert space.sample(5, g, torch.device("cpu")).shape == (5, 11)
    assert torch_make("Swimmer").action_space.sample(2, g, torch.device("cpu")).shape == (2, 2)


def test_make_accepts_gym_suffixes_and_names_unported_tasks():
    assert type(torch_make("HalfCheetah-v4")).__name__ == "HalfCheetah"
    assert type(torch_make("Humanoid-v4")).__name__ == "Humanoid"  # ported: every task of the JAX registry
    assert sorted(REGISTRY) == sorted(__import__("tianshou_tpu.env.mujoco", fromlist=["REGISTRY"]).REGISTRY)
    with pytest.raises(KeyError, match="Humanoid"):
        torch_make("Humanoidd-v4")  # an unknown task names the ported ones


def test_box_with_unbounded_dimensions_matches_jax_from_handed_draws():
    """``Box([-1, -inf], [1, inf])``: the bounded dimension from the uniform, the other the normal,
    bit-exact against the JAX package's ``Box.sample`` for the same key's draws."""
    from tianshou_tpu.env.core import Box as JaxBox

    lo, hi = [-1.0, -np.inf], [1.0, np.inf]
    box, jbox = Box(lo, hi), JaxBox(lo, hi)
    for seed in range(4):
        key = jax.random.key(seed)
        u, n = (np.array(f(key, box.shape)) for f in (jax.random.uniform, jax.random.normal))
        got = box.sample_from(torch.from_numpy(u)[None], torch.from_numpy(n)[None])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbox.sample(key)))
    x = box.sample(20000, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert bool((x[:, 0].abs() <= 1).all()) and float(x[:, 1].abs().max()) > 2.5  # uniform and unbounded normal
    assert abs(float(x[:, 1].std()) - 1.0) < 0.03


def test_env_core_names_match_the_jax_package():
    """``Env.empty_info``, ``Env.name``, ``VectorDeviceEnv.__len__`` and ``Box.low_arr`` / ``high_arr``."""
    from tianshou_tpu.env.core import VectorDeviceEnv as JaxVector

    jenv, tenv = jax_make("Walker2d"), torch_make("Walker2d")
    assert tenv.name == jenv.name == "Walker2d"
    assert len(tenv.empty_info().keys()) == len(jenv.empty_info().keys()) == 0
    assert len(VectorDeviceEnv(tenv, 5, device="cpu")) == len(JaxVector(jenv, 5)) == 5
    for space in ("action_space", "observation_space"):
        for arr in ("low_arr", "high_arr"):
            got, want = getattr(getattr(tenv, space), arr), getattr(getattr(jenv, space), arr)
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_humanoid_steps_through_the_plain_route_with_pair_rows():
    """Humanoid enables geom-pair rows, which the fused kernel does not have: it reports the plain
    route, refuses ``physics_mode="fused"``, and its step is ``dynamics.step``'s on any device."""
    env = torch_make("Humanoid")
    assert env.model.enable_pair_contacts and len(env.model.pair_body1) == 109
    assert env.physics_route == "plain" and torch_make("Hopper").physics_route == "kernel"
    assert torch_make("Hopper", physics_mode="plain").physics_route == "plain"
    with pytest.raises(ValueError, match="pair"):
        torch_make("Humanoid", physics_mode="fused")
    venv = VectorDeviceEnv(env, 2, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, _ = venv.reset(g)
    act = venv.action_space.sample(2, g, torch.device("cpu"))
    out = venv.step(state, act, g)
    from tianshou_tpu_torch.env.physics import dynamics

    want = dynamics.step(env.model, state.q, state.qd, act, frame_skip=env.frame_skip)
    assert torch.equal(out.state.q, want[0]) and torch.equal(out.state.qd, want[1])
