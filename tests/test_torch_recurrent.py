"""The recurrent Q path in the port (tianshou_tpu_torch/models/recurrent.py and
``RecurrentDQN`` in algorithm/modelfree/dqn.py) against the JAX package.

- The three nets with weights converted from flax
  (``recurrent_params_from_flax``): the sequence call and ``step`` from a
  carry agree to atol 1e-6 (float32 gate sums in another order), the carry
  is flax's ``(c, h)``.
- One RecurrentDQN update on the same 4-frame stacked samples: returns, loss,
  TD error at ``test_torch_dqn.py``'s rtol 1e-4 / atol 1e-5, the parameters
  after Adam's first step at its atol 2e-6 for 99.9% and 2e-5 for all.
- 10 collect steps of the carry through ``DeviceCollector`` on a deterministic
  walk whose episodes end inside the window: the carry (reset to zeros where
  an episode ends), the actions and the stored rings agree (rings exactly,
  the carry to atol 1e-5).
- The velocity-masked CartPole of ``tests/test_recurrent.py:62-92`` trained
  to 100 (``slow``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.dqn import RecurrentDQN as JRecurrentDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRight
from tianshou_tpu.models.recurrent import RecurrentActorProb as JActor
from tianshou_tpu.models.recurrent import RecurrentCritic as JCritic
from tianshou_tpu.models.recurrent import RecurrentQNet as JQNet
from tianshou_tpu_torch.algorithm.modelfree.dqn import RecurrentDQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.testing import MoveToRightEnv
from tianshou_tpu_torch.models.convert import recurrent_params_from_flax
from tianshou_tpu_torch.models.recurrent import RecurrentActorProb, RecurrentCritic, RecurrentQNet
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

H, O, A, L, E = 16, 3, 4, 4, 3
NET_TOL = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _load(net, jparams):
    net.load_state_dict(recurrent_params_from_flax(_np_tree(jparams)))
    return net


def test_qnet_sequence_and_step_match_flax():
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((5, L, O)).astype(np.float32)
    jnet = JQNet(H, A)
    jp = jnet.init(jax.random.key(0), jnp.zeros((1, L, O)))
    net = _load(RecurrentQNet(H, A, input_dim=O), jp)
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(obs)).numpy(), np.asarray(jnet.apply(jp, obs)), **NET_TOL)
        np.testing.assert_allclose(net(torch.from_numpy(obs[:, 0])).numpy(), np.asarray(jnet.apply(jp, obs[:, 0])),
                                   **NET_TOL)
        jcarry = jnet.apply(jp, 5, method="zero_carry")
        carry = net.zero_carry(5, "cpu")
        for c_t, c_j in zip(carry, jcarry):
            np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        for t in range(L):  # stepping from zeros walks the same carry as the sequence call
            jq, jcarry = jnet.apply(jp, obs[:, t], jcarry, method="step")
            q, carry = net.step(torch.from_numpy(obs[:, t]), carry)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq), **NET_TOL)
            for c_t, c_j in zip(carry, jcarry):
                np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **NET_TOL)
        np.testing.assert_allclose(q.numpy(), net(torch.from_numpy(obs)).numpy(), **NET_TOL)
        q0, _ = net.step(torch.from_numpy(obs[:, 0]), None)  # no carry: zeros
        np.testing.assert_allclose(q0.numpy(), net(torch.from_numpy(obs[:, :1])).numpy(), **NET_TOL)


def test_actor_and_critic_match_flax():
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, L, O)).astype(np.float32) * 3
    act = rng.standard_normal((6, 2)).astype(np.float32)
    jactor, jcritic = JActor(H, 2), JCritic(H)
    pa = jactor.init(jax.random.key(1), jnp.zeros((1, L, O)))
    pc = jcritic.init(jax.random.key(2), jnp.zeros((1, L, O)), jnp.zeros((1, 2)))
    pv = jcritic.init(jax.random.key(3), jnp.zeros((1, L, O)))
    actor = _load(RecurrentActorProb(H, 2, input_dim=O), pa)
    critic = _load(RecurrentCritic(H, input_dim=O, action_dim=2), pc)
    value = _load(RecurrentCritic(H, input_dim=O), pv)
    with torch.no_grad():
        mu, sigma = actor(torch.from_numpy(obs))
        jmu, jsigma = jactor.apply(pa, obs)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **NET_TOL)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-6, atol=1e-6)
        (smu, ssig), carry = actor.step(torch.from_numpy(obs[:, 0]), actor.zero_carry(6, "cpu"))
        (jsmu, jssig), jcarry = jactor.apply(pa, obs[:, 0], jactor.apply(pa, 6, method="zero_carry"), method="step")
        np.testing.assert_allclose(smu.numpy(), np.asarray(jsmu), **NET_TOL)
        np.testing.assert_allclose(carry[1].numpy(), np.asarray(jcarry[1]), **NET_TOL)
        np.testing.assert_allclose(critic(torch.from_numpy(obs), torch.from_numpy(act)).numpy(),
                                   np.asarray(jcritic.apply(pc, obs, act)), **NET_TOL)
        np.testing.assert_allclose(value(torch.from_numpy(obs)).numpy(), np.asarray(jcritic.apply(pv, obs)), **NET_TOL)


def _algos(**extra):
    kw = dict(gamma=0.9, n_step_return_horizon=3, target_update_freq=2, **extra)
    jalgo = JRecurrentDQN(model=JQNet(H, A), action_space=jcore.Discrete(A), optim=JAdam(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((L, O)))
    net = _load(RecurrentQNet(H, A, input_dim=O), jts.params["model"])
    talgo = RecurrentDQN(model=net, action_space=tcore.Discrete(A), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return jalgo, jts, talgo, talgo.init("cpu")


def _example(B, xp):
    return B(obs=xp.zeros(O, dtype=xp.float32), act=xp.asarray(0, dtype=xp.int32), rew=xp.asarray(0.0, dtype=xp.float32),
             terminated=xp.asarray(False), truncated=xp.asarray(False), obs_next=xp.zeros(O, dtype=xp.float32))


def test_one_recurrent_dqn_update_matches_jax():
    rng = np.random.default_rng(2)
    jb, tb = JVRB(E * 12, E, stack_num=L), VectorReplayBuffer(E * 12, E, stack_num=L)
    js, ts = jb.init(_example(JBatch, jnp)), tb.init(_example(Batch, torch), device="cpu")
    for _ in range(17):
        step = dict(obs=rng.standard_normal((E, O)).astype(np.float32), act=rng.integers(0, A, E).astype(np.int32),
                    rew=rng.standard_normal(E).astype(np.float32), terminated=rng.random(E) < 0.15,
                    truncated=rng.random(E) < 0.05, obs_next=rng.standard_normal((E, O)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    idx = rng.integers(0, E * 12, 24)
    jalgo, jts, talgo, tts = _algos()
    key = jax.random.key(1)
    jbatch = jalgo.preprocess(jts, jb, js, jb.get(js, jnp.asarray(idx), drop_keys=jalgo.update_sample_drop_keys),
                              jnp.asarray(idx), key)
    jts2, jstats = jalgo.update_step(jts, jbatch, key)
    tidx = torch.from_numpy(idx)
    tbatch = tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys)
    np.testing.assert_array_equal(tbatch.obs.numpy(), np.asarray(jbatch.obs))  # [B, L, O] stacks, exactly
    tbatch = talgo.preprocess(tts, tb, ts, tbatch, tidx, torch.Generator())
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    tts, tstats = talgo.update_step(tts, tbatch)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    want = recurrent_params_from_flax(_np_tree(jts2.params["model"]))
    for k, v in tts.model.state_dict().items():
        got, w = v.numpy(), want[k].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(got - w) <= 2e-6) >= 0.999, k
    assert int(tts.step) == int(jts2.step) == 1


def test_init_policy_state_and_acting():
    jalgo, jts, talgo, tts = _algos()
    carry = talgo.init_policy_state(E, "cpu")
    jcarry = jalgo.init_policy_state(E)
    assert len(carry) == 2 and all(c.shape == (E, H) for c in carry)
    for c_t, c_j in zip(carry, jcarry):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    obs = np.random.default_rng(3).standard_normal((E, O)).astype(np.float32)
    out = talgo.forward(tts, torch.from_numpy(obs), state=carry)
    jout = jalgo.forward(jts, jnp.asarray(obs), jax.random.key(0), state=jcarry)
    np.testing.assert_array_equal(out.act.numpy(), np.asarray(jout.act))
    np.testing.assert_allclose(out.info.q.numpy(), np.asarray(jout.info.q), **NET_TOL)
    for c_t, c_j in zip(out.state, jout.state):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **NET_TOL)


def test_ten_collect_steps_of_the_carry_match_jax():
    """MoveToRight of size 3 truncated at 4 steps: every env's episode ends
    inside the 10 steps, so the carry's reset on done is part of the window."""
    jalgo, jts, talgo, tts = _algos()
    jenv, tenv = JMoveToRight(size=3, max_episode_steps=4), MoveToRightEnv(size=3, max_episode_steps=4)
    jalgo.model, talgo.model = JQNet(H, A), RecurrentQNet(H, A, input_dim=1)
    jts = jalgo.init(jax.random.key(4), jnp.zeros((L, 1)))
    # a nonzero embedding bias, so that the carry moves at position 0 too
    model = jax.tree.map(lambda x: x, jts.params["model"])
    model["params"]["embed"]["bias"] = jnp.asarray(np.random.default_rng(7).standard_normal(H), jnp.float32)
    jts = jts.replace(params={"model": model})
    talgo.model.load_state_dict(recurrent_params_from_flax(_np_tree(jts.params["model"])))
    tts = talgo.init("cpu")
    ex = dict(obs=np.zeros(1, np.float32), act=np.int32(0), rew=np.float32(0), terminated=False, truncated=False,
              obs_next=np.zeros(1, np.float32))
    jb, tb = JVRB(E * 16, E), VectorReplayBuffer(E * 16, E)
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    jcoll = JCollector(jcore.VectorDeviceEnv(jenv, E), jalgo, jb)
    tcoll = DeviceCollector(tcore.VectorDeviceEnv(tenv, E, device="cpu"), talgo, tb)
    jc = jcoll.reset(jax.random.key(5))
    tc = tcoll.reset(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    dones, carried = [], []
    for part in range(2):  # 10 steps as 5 + 5, the carry held against JAX's after each
        jc, js, jout = jcoll.collect(jts, jc, js, jax.random.key(6 + part), 5, training=False)
        tc, ts, tout = tcoll.collect(tts, tc, ts, g, 5, training=False)
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        for c_t, c_j in zip(tc.policy_state, jc.policy_state):
            np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-5)
        dones.append(np.asarray(jout.done))
        carried.append(not np.allclose(tc.policy_state[1].numpy(), 0.0))
    assert np.concatenate(dones).any(axis=0).all() and any(carried)
    for k in ("obs", "act", "rew", "done", "obs_next"):
        np.testing.assert_array_equal(ts.data[k].numpy(), np.asarray(js.data[k]), err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_recurrent.py:62-92, on the CPU
# ---------------------------------------------------------------------------
class MaskVelocity(tcore.Env):
    """POMDP CartPole: only the position and the angle are observed."""

    def __init__(self, env):
        self.env = env
        self.observation_space = tcore.Box(low=[-4.8, -0.5], high=[4.8, 0.5])
        self.action_space = env.action_space
        self.max_episode_steps = env.max_episode_steps

    def reset(self, num_envs, generator, device):
        s, obs = self.env.reset(num_envs, generator, device)
        return s, obs[:, 0::2]  # the position and the angle

    def step(self, state, action, generator):
        s = self.env.step(state, action, generator)
        return s._replace(obs=s.obs[:, 0::2])


@pytest.mark.slow
def test_recurrent_dqn_pomdp_cartpole():
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.manual_seed(0)
    env = MaskVelocity(CartPole())
    algo = RecurrentDQN(model=RecurrentQNet(64, 2, input_dim=2), action_space=env.action_space,
                        optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3,
                        target_update_freq=320, eps_training=0.3)
    buffer = VectorReplayBuffer(20000, 10, stack_num=4)
    ex = Batch(obs=torch.zeros(2), act=torch.zeros((), dtype=torch.int64), rew=torch.zeros(()),
               terminated=torch.zeros((), dtype=torch.bool), truncated=torch.zeros((), dtype=torch.bool),
               obs_next=torch.zeros(2))
    bs = buffer.init(ex, device="cpu")
    tc = DeviceCollector(tcore.VectorDeviceEnv(env, 10, device="cpu"), algo, buffer)
    ec = DeviceCollector(tcore.VectorDeviceEnv(env, 10, device="cpu"), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=12, epoch_num_steps=5000, test_step_num_episodes=10, batch_size=64,
        collection_step_num_env_steps=10, update_per_step=0.2, start_steps=1000, stop_fn=lambda r: r >= 100,
        train_fn=lambda ep, step: {"eps_training": max(0.05, 0.3 * (1 - step / 40000))}, verbose=False)
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(algo.init("cpu"), bs, torch.Generator().manual_seed(0))
    assert res.best_reward >= 100, f"best_reward {res.best_reward}"
