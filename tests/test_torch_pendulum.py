"""The port's batched Pendulum against the JAX package's (vmapped) one: the
same reset (the JAX key's uniforms handed to ``reset_from``), then 200 steps
of the same actions, some beyond the torque limit of 2.

Tolerances:
- each step from the JAX package's state: observation, reward and next state
  within atol 2e-6 (measured at most 9.5e-7: ``sin``, ``cos`` and the float32
  update round differently in each package);
- the two trajectories run free for 200 steps: observations within 2e-2 and
  rewards within 5e-2 (measured 5.1e-3 and 1.7e-2; 1.1e-4 and 2.1e-4 over
  the first 50 steps): the swing-up dynamics carry one step's last-bit
  differences on and grow them;
- the step counter, truncation at step 200 and termination (never) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tianshou_tpu.env.classic.pendulum import Pendulum as JPendulum
from tianshou_tpu_torch.env.classic.pendulum import Pendulum, PendulumState
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, STEPS = 16, 200
STEP_TOL = dict(rtol=0, atol=2e-6)


def t(x):
    return torch.from_numpy(np.array(x))


def test_pendulum_matches_jax_over_an_episode():
    jenv, env = JPendulum(), Pendulum()
    keys = jax.random.split(jax.random.key(0), E)
    js, jobs = jax.vmap(jenv.reset)(keys)
    uniform = np.stack([np.asarray(jax.random.uniform(k, (2,))) for k in keys])
    s, obs = env.reset_from(t(uniform))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **STEP_TOL)
    actions = np.random.default_rng(0).uniform(-2.5, 2.5, (STEPS, E, 1)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    for i in range(STEPS):
        act = t(actions[i])
        jout = jstep(js, jnp.asarray(actions[i]), jax.random.key(1))
        forced = env.step(PendulumState(t(js.theta), t(js.theta_dot), t(js.t)), act, None)
        for got, want in ((forced.obs, jout.obs), (forced.reward, jout.reward),
                          (forced.state.theta, jout.state.theta), (forced.state.theta_dot, jout.state.theta_dot)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL, err_msg=f"step {i}")
        out = env.step(s, act, None)
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(jout.obs), rtol=0, atol=2e-2, err_msg=f"step {i}")
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward), rtol=0, atol=5e-2, err_msg=f"step {i}")
        for got in (forced, out):
            np.testing.assert_array_equal(got.state.t.numpy(), np.asarray(jout.state.t))
            np.testing.assert_array_equal(got.truncated.numpy(), np.asarray(jout.truncated))
            np.testing.assert_array_equal(got.terminated.numpy(), np.asarray(jout.terminated))
        assert out.obs.dtype == out.reward.dtype == torch.float32
        s, js = out.state, jout.state
    assert bool(out.truncated.all()) and not bool(out.terminated.any())


def test_pendulum_reset_draws_uniforms_from_the_generator_and_spaces():
    env = Pendulum()
    s, obs = env.reset(5, torch.Generator().manual_seed(3), "cpu")
    s2, obs2 = env.reset_from(torch.rand((5, 2), generator=torch.Generator().manual_seed(3)))
    assert torch.equal(obs, obs2) and obs.shape == (5, 3) and s.t.dtype == torch.int32
    assert bool((s.theta >= -np.pi).all() and (s.theta < np.pi).all() and (s.theta_dot.abs() <= 1).all())
    jenv = JPendulum()
    assert env.action_space.low == jenv.action_space.low == (-2.0,) and env.action_space.high == (2.0,)
    assert env.observation_space.high == jenv.observation_space.high and env.max_episode_steps == 200
