"""``MultiDiscrete`` and the action and termination wrappers of the port
(``ContinuousToDiscrete``, ``MultiDiscreteToDiscrete``,
``TruncatedAsTerminated``) against the JAX package, on the CPU.

Both frameworks wrap the same deterministic env, defined here in each:
its observation is the last action it was given and its time step, its
reward the action's sum, and it is truncated at step 4 and terminated
where the first action dim reaches its high bound. The same action
sequences go through both wrapper chains over 6 envs for 9 steps (with the
collector's reset of finished envs), and every observation, reward,
termination and truncation is held bit-exact. ``ContinuousToDiscrete``'s
bin points are ``jnp.linspace``'s formula; XLA fuses it, so the port's
points are held within 2 ulp of the larger bound's magnitude of JAX's
(a point near 0 comes out of a cancellation), and the step-for-step check hands
JAX's points over. ``MultiDiscrete.sample`` is ``floor(u * nvec)`` of the
generator's float32 uniforms, in range, every value drawn.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env import wrappers as jwrappers
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env import wrappers
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, STEPS = 6, 9
LOW, HIGH = [-1.0, 0.0], [1.0, 2.5]


class JEchoState(NamedTuple):
    last: jnp.ndarray
    t: jnp.ndarray


class JEcho(jcore.Env):
    observation_space = jcore.Box(-10.0, 10.0, (3,))
    action_space = jcore.Box(LOW, HIGH)

    def reset(self, key):
        s = JEchoState(jnp.zeros(2, jnp.float32), jnp.int32(0))
        return s, jnp.concatenate([s.last, s.t.astype(jnp.float32)[None]])

    def step(self, state, action, key):
        s = JEchoState(action.astype(jnp.float32), state.t + 1)
        term = action[0] >= HIGH[0]
        obs = jnp.concatenate([s.last, s.t.astype(jnp.float32)[None]])
        return jcore.EnvStep(s, obs, action.sum().astype(jnp.float32), term, (s.t >= 4) & ~term, JBatch())


class EchoState(NamedTuple):
    last: torch.Tensor
    t: torch.Tensor


class Echo(tcore.Env):
    observation_space = tcore.Box(-10.0, 10.0, (3,))
    action_space = tcore.Box(LOW, HIGH)

    def reset(self, num_envs, generator, device):
        s = EchoState(torch.zeros(num_envs, 2, device=device), torch.zeros(num_envs, dtype=torch.int32, device=device))
        return s, torch.cat([s.last, s.t.to(torch.float32)[:, None]], dim=1)

    def step(self, state, action, generator):
        s = EchoState(action.to(torch.float32), state.t + 1)
        term = action[:, 0] >= HIGH[0]
        obs = torch.cat([s.last, s.t.to(torch.float32)[:, None]], dim=1)
        return tcore.EnvStep(s, obs, action.sum(1).to(torch.float32), term, (s.t >= 4) & ~term, Batch())


def _run(jenv, tenv, actions):
    """Step both chains through ``actions`` [STEPS, E, ...] with the collector's reset of finished envs."""
    jv, tv = jcore.VectorDeviceEnv(jenv, E), tcore.VectorDeviceEnv(tenv, E, device="cpu")
    js, _ = jv.reset(jax.random.key(0))
    ts, _ = tv.reset(torch.Generator())
    for a in actions:
        jstep = jv.step(js, jnp.asarray(a), jax.random.key(1))
        tstep = tv.step(ts, torch.from_numpy(a), torch.Generator())
        for f in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tstep, f).numpy(), np.asarray(getattr(jstep, f)), err_msg=f)
        done = tstep.terminated | tstep.truncated
        jr, _ = jv.reset(jax.random.key(2))
        tr, _ = tv.reset(torch.Generator())
        js = jax.tree.map(lambda n, o: jnp.where(jnp.asarray(done.numpy()).reshape((E,) + (1,) * (o.ndim - 1)), n, o),
                          jr, jstep.state)
        ts = type(tstep.state)(*(torch.where(done.reshape((E,) + (1,) * (o.dim() - 1)), n, o)
                                 for n, o in zip(tr, tstep.state)))
    return tstep


@pytest.mark.parametrize("bins", [2, 3, 5, 7, 11])
def test_continuous_to_discrete_points_match_jax(bins):
    want = np.asarray(jwrappers.ContinuousToDiscrete(JEcho(), bins)._mesh)
    got = wrappers.ContinuousToDiscrete(Echo(), bins)._mesh.numpy()
    assert got.shape == want.shape == (2, bins) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, [0, -1]], want[:, [0, -1]])  # the bounds exactly
    scale = np.maximum(np.abs(want[:, :1]), np.abs(want[:, -1:]))  # a point near 0 comes out of a cancellation
    assert np.all(np.abs(got - want) <= 2 * np.finfo(np.float32).eps * scale)


def test_continuous_to_discrete_step_for_step():
    jenv, tenv = jwrappers.ContinuousToDiscrete(JEcho(), 5), wrappers.ContinuousToDiscrete(Echo(), 5)
    tenv._mesh = torch.from_numpy(np.array(jenv._mesh))
    assert tenv.action_space == tcore.MultiDiscrete([5, 5]) and tenv.observation_space == Echo.observation_space
    actions = np.random.default_rng(0).integers(0, 5, (STEPS, E, 2))
    last = _run(jenv, tenv, actions)
    assert last.obs.dtype == torch.float32


def test_multidiscrete_to_discrete_step_for_step():
    jenv = jwrappers.MultiDiscreteToDiscrete(jwrappers.ContinuousToDiscrete(JEcho(), 3))
    tenv = wrappers.MultiDiscreteToDiscrete(wrappers.ContinuousToDiscrete(Echo(), 3))
    tenv.env._mesh = torch.from_numpy(np.array(jenv.env._mesh))
    assert tenv.action_space == tcore.Discrete(9)
    actions = np.random.default_rng(1).integers(0, 9, (STEPS, E))
    _run(jenv, tenv, actions)
    # the first sub-action is the most significant digit
    step = tenv.step(tenv.reset(2, None, "cpu")[0], torch.tensor([7, 2]), None)
    np.testing.assert_array_equal(step.obs[:, :2].numpy(), tenv.env._mesh.numpy()[[0, 1], [[2, 1], [0, 2]]])


def test_truncated_as_terminated_step_for_step():
    jenv, tenv = jwrappers.TruncatedAsTerminated(JEcho()), wrappers.TruncatedAsTerminated(Echo())
    rng = np.random.default_rng(2)
    actions = np.stack([rng.uniform(LOW[0], HIGH[0] - 0.1, (STEPS, E)), rng.uniform(LOW[1], HIGH[1], (STEPS, E))],
                       axis=-1).astype(np.float32)
    last = _run(jenv, tenv, actions)
    assert not bool(last.truncated.any())
    assert bool(tenv.step(tenv.reset(E, None, "cpu")[0]._replace(t=torch.full((E,), 3, dtype=torch.int32)),
                          torch.from_numpy(actions[0]), None).terminated.all())  # the step-4 truncation


def test_multidiscrete_sample():
    space = tcore.MultiDiscrete([2, 3, 5])
    jspace = jcore.MultiDiscrete([2, 3, 5])
    assert space.shape == jspace.shape == (3,) and space.nvec == jspace.nvec
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    x = space.sample(1000, g, torch.device("cpu"))
    assert x.shape == (1000, 3) and x.dtype == torch.int64
    g.set_state(state)
    u = torch.rand((1000, 3), generator=g)
    torch.testing.assert_close(x, (u * torch.tensor([2.0, 3.0, 5.0])).to(torch.int64), rtol=0, atol=0)
    for i, n in enumerate((2, 3, 5)):
        assert sorted(x[:, i].unique().tolist()) == list(range(n))
    j = np.asarray(jax.vmap(jspace.sample)(jax.random.split(jax.random.key(0), 1000)))
    assert j.min() >= 0 and (j < np.array([2, 3, 5])).all()
