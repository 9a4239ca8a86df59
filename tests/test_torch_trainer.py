"""The port's trainer with its test phase, hooks and loggers, against the JAX
trainer.

Both frameworks train ``DQN(Net)`` on ``MoveToRightEnv(size=5,
max_episode_steps=3)``: every episode ends at its third step whatever the
policy does, so the episode counts, and with them which writes happen, do
not depend on the random streams, which differ between the frameworks.

- With a logger that records every write (all intervals 1): the same
  ``(step_type, step, sorted keys)`` writes in the same order, and the same
  ``env_step``, ``gradient_step`` and ``epochs``; ``save_best_fn`` at the
  first test only (the score never improves on it), ``save_checkpoint_fn``
  at every epoch with ``(epoch, env_step, gradient_step, train state)``.
- ``stop_fn=lambda r: True`` stops both after epoch 1; with
  ``test_in_train`` both stop inside epoch 1, after the first chunk.
- ``test_fn``'s overrides hold during the test phase only: after a test
  phase ``eps_training`` is ``train_fn``'s value and ``eps_inference`` its
  own again.
- ``save_best_fn`` gets the live train state, with the weights the test ran
  on.
- ``resume_from_log`` through ``TensorboardLogger`` restores the counters.
- ``start_random=False`` prefills with the policy's actions.
- A two-epoch CartPole run returns ten test episodes per epoch.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_collectors, transition_example
from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRightEnv
from tianshou_tpu.models.mlp import Net as JNet
from tianshou_tpu.trainer.trainer import OffPolicyTrainer as JTrainer
from tianshou_tpu.trainer.trainer import OffPolicyTrainerParams as JParams
from tianshou_tpu.utils.logger.base import BaseLogger as JBaseLogger
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.testing import MoveToRightEnv
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams
from tianshou_tpu_torch.utils.determinism import trace_param_hash
from tianshou_tpu_torch.utils.logger.base import BaseLogger
from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E_TRAIN, E_TEST, T = 2, 3, 6
ALGO = dict(gamma=0.9, n_step_return_horizon=2, target_update_freq=4, eps_training=0.5, eps_inference=0.05)
COMMON = dict(max_epochs=3, epoch_num_steps=2 * T * E_TRAIN, test_step_num_episodes=4, batch_size=8,
              collection_step_num_env_steps=T, update_per_step=0.25, start_steps=T * E_TRAIN, verbose=False)


def recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__(train_interval=1, test_interval=1, update_interval=1, info_interval=1)
            self.writes = []

        def write(self, step_type, step, data):
            self.writes.append((step_type, int(step), dict(data)))

    return Recorder()


def keys_of(writes):
    return [(t, s, tuple(sorted(d))) for t, s, d in writes]


def run_jax(**kw):
    env = JMoveToRightEnv(size=5, max_episode_steps=3)
    algo = JDQN(model=JNet((16,), 2), action_space=env.action_space, optim=JAdam(lr=1e-3), **ALGO)
    buffer = JVRB(total_size=64, buffer_num=E_TRAIN)
    tc, vc = make_collectors(env, algo, buffer, n_train=E_TRAIN, n_test=E_TEST)
    trainer = JTrainer(algo, tc, vc, buffer, JParams(**{**COMMON, **kw}))
    return trainer.run(algo.init(jax.random.key(0), jnp.zeros(1)), buffer.init(transition_example(env)),
                       jax.random.key(1))


def make_port(size=5, max_episode_steps=3, test_hook=None, **kw):
    torch.manual_seed(0)
    env = MoveToRightEnv(size=size, max_episode_steps=max_episode_steps)
    algo = DQN(model=Net((16,), 2, input_dim=1), action_space=env.action_space, optim=AdamOptimizerFactory(lr=1e-3),
               **ALGO)
    buffer = VectorReplayBuffer(64, E_TRAIN)
    bs = buffer.init(Batch(obs=torch.zeros(1), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(1)),
                     device="cpu")
    tc = DeviceCollector(VectorDeviceEnv(env, E_TRAIN, device="cpu"), algo, buffer)
    vc = DeviceCollector(VectorDeviceEnv(env, E_TEST, device="cpu"), algo, None, on_step_hook=test_hook)
    trainer = OffPolicyTrainer(algo, tc, vc, buffer, OffPolicyTrainerParams(**{**COMMON, **kw}))
    return trainer, algo.init("cpu"), bs


def run_port(**kw):
    trainer, ts, bs = make_port(**kw)
    return trainer.run(ts, bs, torch.Generator().manual_seed(1))


def test_logger_writes_and_counters_match_jax():
    calls = {"jax": [], "port": []}
    res = {}
    for side, run, base in (("jax", run_jax, JBaseLogger), ("port", run_port, BaseLogger)):
        logger = recorder(base)
        res[side] = run(logger=logger, save_best_fn=lambda ts, c=calls[side]: c.append("best"),
                        save_checkpoint_fn=lambda *a, c=calls[side]: c.append(("ckpt", *a[:3])))
        res[side + "_writes"] = logger.writes
    jw, tw = res["jax_writes"], res["port_writes"]
    assert keys_of(tw) == keys_of(jw)
    kinds = [w[0] for w in tw]
    assert kinds.count("test/env_step") == kinds.count("info/epoch") == 3 and kinds.count("train/env_step") == 6
    for side in ("jax", "port"):
        r = res[side]
        assert (r.env_step, r.gradient_step, r.epochs) == (12 + 3 * 24, 3 * 2 * 3, 3)
        assert calls[side] == ["best", ("ckpt", 1, 36, 6), ("ckpt", 2, 60, 12), ("ckpt", 3, 84, 18)]
        assert r.best_reward == r.best_score == 0.0
    assert set(res["port"].timing) == {"prefill", "collect", "update", "test"} and res["port"].timing["test"] > 0
    for _, _, data in tw:
        assert all(np.isfinite(v) for v in data.values())
    test_writes = [d for t, _, d in tw if t == "test/env_step"]
    assert all(d["test/n_episodes"] == 4 and d["test/length"] == 3.0 for d in test_writes)


def test_stop_fn_stops_after_the_first_epoch():
    for r in (run_jax(stop_fn=lambda r: True), run_port(stop_fn=lambda r: True)):
        assert (r.epochs, r.env_step, r.gradient_step) == (1, 36, 6)


def test_test_in_train_stops_early():
    for r in (run_jax(stop_fn=lambda r: True, test_in_train=True),
              run_port(stop_fn=lambda r: True, test_in_train=True)):
        assert (r.epochs, r.env_step, r.gradient_step) == (1, 24, 0)
        assert r.best_reward == 0.0


def test_test_fn_overrides_hold_during_the_test_only():
    during = []
    trainer, ts, bs = make_port(
        train_fn=lambda epoch, step: {"eps_training": 0.4},
        test_fn=lambda epoch, step: {"eps_training": 0.9, "eps_inference": 0.7},
        test_hook=lambda tr: (during.append((float(ts.hparams["eps_training"]), float(ts.hparams["eps_inference"]))),
                              tr)[1],
    )
    res = trainer.run(ts, bs, torch.Generator().manual_seed(1))
    assert res.epochs == 3 and len(during) >= 3 * 3
    assert set(during) == {(float(np.float32(0.9)), float(np.float32(0.7)))}  # float32 scalars
    assert float(ts.hparams["eps_training"]) == pytest.approx(0.4)  # train_fn's, not test_fn's
    assert float(ts.hparams["eps_inference"]) == pytest.approx(0.05)  # the algorithm's own


def test_save_best_fn_gets_the_live_train_state():
    seen = {}
    trainer, ts, bs = make_port(test_hook=lambda tr: (seen.setdefault("tested", trace_param_hash(ts)), tr)[1])

    def save_best(state):
        seen["state"] = state
        seen["weights"] = copy.deepcopy(state.model.state_dict())
        seen["hash"] = trace_param_hash(state)

    trainer.params.save_best_fn = save_best
    trainer.run(ts, bs, torch.Generator().manual_seed(1))
    assert seen["state"] is ts
    assert seen["hash"] == seen["tested"]  # the weights the first test ran on
    moved = [not torch.equal(a, b) for a, b in zip(seen["weights"].values(), ts.model.state_dict().values())]
    assert any(moved)  # later updates wrote the live tensors in place


def test_resume_from_log_restores_the_counters(tmp_path):
    first = run_port(logger=TensorboardLogger(log_dir=str(tmp_path)), max_epochs=2)
    assert (first.env_step, first.gradient_step, first.epochs) == (60, 12, 2)
    trainer, ts, bs = make_port(logger=TensorboardLogger(log_dir=str(tmp_path)), resume_from_log=True,
                                start_steps=0)
    assert (trainer.start_epoch, trainer.env_step, trainer.gradient_step) == (2, 60, 12)
    res = trainer.run(ts, bs, torch.Generator())
    assert (res.env_step, res.gradient_step, res.epochs) == (84, 18, 3)


@pytest.mark.parametrize("start_random", [False, True])
def test_start_random_false_prefills_with_the_policy(start_random):
    trainer, ts, bs = make_port(size=100, max_episode_steps=100, max_epochs=0, start_steps=4 * T * E_TRAIN,
                                start_random=start_random)
    ts.hparams["eps_training"].fill_(0.0)  # the policy's actions are its greedy ones
    res = trainer.run(ts, bs, torch.Generator().manual_seed(0))
    assert res.env_step == 4 * T * E_TRAIN and res.gradient_step == 0
    acts = res.buf_state.data.act[:, :4 * T].reshape(-1)
    greedy = ts.model(res.buf_state.data.obs[:, :4 * T].reshape(-1, 1)).argmax(-1)
    assert torch.equal(acts, greedy) == (not start_random)


def test_cartpole_two_epochs_test_ten_episodes_each():
    torch.manual_seed(0)
    env = CartPole()
    algo = DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=320,
               eps_training=0.3)
    buffer = VectorReplayBuffer(20000, 10)
    bs = buffer.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(4)),
                     device="cpu")
    logger = recorder(BaseLogger)
    trainer = OffPolicyTrainer(
        algo, DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, buffer),
        DeviceCollector(VectorDeviceEnv(env, 10, device="cpu"), algo, None), buffer,
        OffPolicyTrainerParams(max_epochs=2, epoch_num_steps=1000, test_step_num_episodes=10, batch_size=64,
                               collection_step_num_env_steps=10, update_per_step=0.1, start_steps=1000,
                               logger=logger, verbose=False))
    res = trainer.run(algo.init("cpu"), bs, torch.Generator().manual_seed(0))
    tests = [d for t, _, d in logger.writes if t == "test/env_step"]
    assert res.epochs == 2 and res.env_step == 3000 and res.gradient_step == 200
    assert [d["test/n_episodes"] for d in tests] == [10, 10]
    assert all(np.isfinite(d["test/reward"]) and d["test/length"] >= 8 for d in tests)
