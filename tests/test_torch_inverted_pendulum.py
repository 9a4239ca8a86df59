"""The port's batched InvertedPendulum and InvertedDoublePendulum against the
JAX package's (vmapped) ones: the same reset (the JAX keys' uniforms handed to
``reset_from_noise``), then steps of the same actions, some beyond the force
limit.

Tolerances:
- each step from the JAX package's state: state, observation and reward
  within atol 2e-6 (InvertedPendulum) and 2e-5 of the largest magnitude
  (InvertedDoublePendulum, whose 3x3 solve is LU in both packages with other
  rounding); terminations and truncations equal;
- the trajectories run free for 100 steps (InvertedPendulum, no termination
  there at small forces): observations within 1e-4.

Then the ``slow`` twins of ``tests/test_mujoco_table.py``: SAC, TD3 and PPO
to InvertedPendulum's 1,000 within the reference tests' budgets, and the
InvertedDoublePendulum smoke run:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_inverted_pendulum.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.classic.inverted_pendulum import InvertedDoublePendulum as JIDP
from tianshou_tpu.env.classic.inverted_pendulum import InvertedPendulum as JIP
from tianshou_tpu_torch.env.classic.inverted_pendulum import InvertedDoublePendulum, InvertedPendulum, PendState
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E = 16
PAIRS = {"InvertedPendulum": (JIP, InvertedPendulum), "InvertedDoublePendulum": (JIDP, InvertedDoublePendulum)}


def t(x):
    return torch.from_numpy(np.array(x))


def reset_both(name):
    jcls, tcls = PAIRS[name]
    jenv, env = jcls(), tcls()
    keys = jax.random.split(jax.random.key(0), E)
    js, jobs = jax.vmap(jenv.reset)(keys)
    init = np.stack([np.asarray(jax.random.uniform(k, (2 * env.n,), minval=-0.01, maxval=0.01)) for k in keys])
    s, obs = env.reset_from_noise(t(init))
    return jenv, env, js, jobs, s, obs


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reset_from_handed_noise_matches_jax(name):
    jenv, env, js, jobs, s, obs = reset_both(name)
    np.testing.assert_array_equal(s.q.numpy(), np.asarray(js.q))
    np.testing.assert_array_equal(s.qd.numpy(), np.asarray(js.qd))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-7)
    assert obs.dtype == torch.float32 and s.t.dtype == torch.int32 and s.t.tolist() == [0] * E
    assert env.observation_space.low == jenv.observation_space.low and env.action_space.high == jenv.action_space.high
    s2, obs2 = env.reset(E, torch.Generator().manual_seed(1), "cpu")
    assert bool((s2.q.abs() <= 0.01).all() and (s2.qd.abs() <= 0.01).all()) and obs2.shape == obs.shape


@pytest.mark.parametrize("name,steps,scale", [("InvertedPendulum", 300, 1.3), ("InvertedDoublePendulum", 300, 1.3)])
def test_step_for_step_matches_jax(name, steps, scale):
    """Every step from the JAX package's own state, with actions beyond the limit: the pole falls, so
    terminations come; the tolerance is stated in the module's docstring."""
    jenv, env, js, _, _, _ = reset_both(name)
    atol = 2e-6 if name == "InvertedPendulum" else 2e-5
    actions = np.random.default_rng(0).uniform(-scale, scale, (steps, E, 1)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    terminated = 0
    for i in range(steps):
        jout = jstep(js, jnp.asarray(actions[i]), jax.random.key(1))
        out = env.step(PendState(t(js.q), t(js.qd), t(js.t)), t(actions[i]))
        for got, want in ((out.state.q, jout.state.q), (out.state.qd, jout.state.qd), (out.obs, jout.obs),
                          (out.reward, jout.reward)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol * max(1.0, np.abs(want).max()),
                                       err_msg=f"step {i}")
        np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(out.truncated.numpy(), np.asarray(jout.truncated))
        np.testing.assert_array_equal(out.state.t.numpy(), np.asarray(jout.state.t))
        assert out.reward.dtype == torch.float32
        terminated += int(out.terminated.sum())
        js = jout.state
    assert terminated > 0


def test_inverted_pendulum_free_trajectory_matches_jax():
    jenv, env, js, _, s, _ = reset_both("InvertedPendulum")
    actions = np.random.default_rng(2).uniform(-0.05, 0.05, (100, E, 1)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)))
    for i in range(100):
        jout = jstep(js, jnp.asarray(actions[i]), jax.random.key(1))
        out = env.step(s, t(actions[i]))
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(jout.obs), rtol=0, atol=1e-4, err_msg=f"step {i}")
        s, js = out.state, jout.state


def test_the_rail_stops_the_cart_and_the_double_pendulum_tip_terminates():
    env = InvertedPendulum()
    s = PendState(torch.tensor([[0.999, 0.0]]), torch.tensor([[5.0, 0.0]]), torch.zeros(1, dtype=torch.int32))
    out = env.step(s, torch.ones(1, 1))
    assert float(out.state.q[0, 0]) == 1.0 and float(out.state.qd[0, 0]) == 0.0
    idp = InvertedDoublePendulum(max_episode_steps=1)
    s = PendState(torch.tensor([[0.0, 1.5, 1.5], [0.0, 0.0, 0.0]]), torch.zeros(2, 3), torch.zeros(2, dtype=torch.int32))
    out = idp.step(s, torch.zeros(2, 1))
    assert out.terminated.tolist() == [True, False] and out.truncated.tolist() == [False, True]


# ---------------------------------------------------------------------------
# the slow twins of tests/test_mujoco_table.py
# ---------------------------------------------------------------------------
def _run_offpolicy(env, algo, obs_dim, stop, max_epochs=12, update_per_step=0.5):
    """``tests/test_mujoco_table.py:_run`` on the CPU: 8 train and 10 test envs, a 100,000-row buffer,
    batch 256, T 8, a 2,000-step prefill of the policy, epochs of 5,000 steps."""
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    buffer = VectorReplayBuffer(100000, 8)
    bs = buffer.init(Batch(obs=torch.zeros(obs_dim), act=torch.zeros(1), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False),
                           obs_next=torch.zeros(obs_dim)), device="cpu")
    params = OffPolicyTrainerParams(
        max_epochs=max_epochs, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=256,
        collection_step_num_env_steps=8, update_per_step=update_per_step, start_steps=2000, start_random=False,
        stop_fn=lambda r: r >= stop, verbose=False,
    )
    trainer = OffPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 8, device="cpu"), algo, buffer),
                               DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), buffer, params)
    return trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(0))


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["sac", "td3"])
def test_offpolicy_inverted_pendulum_full_score(kind):
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import (ContinuousActorDeterministic, ContinuousActorProbabilistic,
                                                      ContinuousCritic)

    torch.manual_seed(0)
    env = InvertedPendulum()
    critic = ContinuousCritic((128, 128), input_dim=4, action_dim=1)
    opt = dict(policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4))
    if kind == "sac":
        algo = SAC(actor=ContinuousActorProbabilistic((128, 128), 1, conditioned_sigma=True, input_dim=4), critic=critic,
                   action_space=env.action_space, gamma=0.99, tau=0.005, **opt)
    else:
        algo = TD3(actor=ContinuousActorDeterministic((128, 128), 1, input_dim=4), critic=critic,
                   action_space=env.action_space, gamma=0.99, tau=0.005, **opt)
    result = _run_offpolicy(env, algo, 4, stop=1000)
    # the reference table's row: 1000.0 +- 0.0 (examples/mujoco/README.md)
    assert result.best_reward == 1000.0, f"{kind}: best_reward {result.best_reward} after {result.epochs} epochs"


@pytest.mark.slow
def test_ppo_inverted_pendulum_full_score():
    """The on-policy row of the same table (PPO: 1000.0 +- 0.0)."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic
    from tianshou_tpu_torch.models.discrete import DiscreteCritic
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    torch.manual_seed(0)
    env = InvertedPendulum()
    algo = PPO(actor=ContinuousActorProbabilistic((64, 64), 1, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
               action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), gamma=0.99,
               gae_lambda=0.95, eps_clip=0.2, ent_coef=0.0, deterministic_eval=True)
    params = OnPolicyTrainerParams(
        max_epochs=8, epoch_num_steps=20000, test_step_num_episodes=10, batch_size=512,
        collection_step_num_env_steps=128, update_step_num_repetitions=10, stop_fn=lambda r: r >= 1000, verbose=False,
    )
    trainer = OnPolicyTrainer(algo, DeviceCollector(VectorDeviceEnv(env, 16, device="cpu"), algo, None),
                              DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), params)
    result = trainer.run(algo.init("cpu"), torch.Generator().manual_seed(0))
    assert result.best_reward == 1000.0, f"best_reward {result.best_reward}"


@pytest.mark.slow
def test_inverted_double_pendulum_smoke():
    """The double pendulum's dynamics stay finite and its reward bounded over random steps."""
    venv = VectorDeviceEnv(InvertedDoublePendulum(), 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, _ = venv.reset(g)
    for _ in range(5):
        step = venv.step(state, torch.zeros(4, 1), g)
        state = step.state
    assert bool(torch.isfinite(step.obs).all()) and float(step.reward.max()) <= 10.0
