"""The port's ``OnPolicyTrainer`` against the JAX one, on CartPole.

Both frameworks train ``PPO(DiscreteActor, DiscreteCritic)`` on
``NormObs(CartPole())`` (4 train envs, 3 test envs with frozen statistics,
rollouts of 32 steps, 2 passes of 2 minibatches) for two epochs of two
rollouts each. A near-random policy ends a CartPole episode within 32 steps
in at least one of four envs, so every rollout logs a train reward on both
sides, whatever the random streams (which differ between the frameworks).

- With a logger that records every write: the same ``(step_type, step,
  sorted keys)`` writes in the same order, and the same ``env_step``,
  ``gradient_step`` (``repeat x n_minibatches`` per rollout) and ``epochs``;
  ``stop_fn=lambda r: True`` stops both after the first epoch, and with
  ``test_in_train`` after the first rollout, before its update.
- The handoff: every test phase gets the train envs' pooled statistics at
  that moment, and the test envs run under them.
- ``train_fn`` writes a hyper-parameter that the graphs read in place, and
  ``save_checkpoint_fn`` and ``resume_from_log`` behave as off-policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.helpers import make_collectors
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.env.classic.cartpole import CartPole as JCartPole
from tianshou_tpu.env.wrappers import NormObs as JNormObs
from tianshou_tpu.models.discrete import DiscreteActor as JDiscreteActor
from tianshou_tpu.models.discrete import DiscreteCritic as JDiscreteCritic
from tianshou_tpu.trainer.trainer import OnPolicyTrainer as JTrainer
from tianshou_tpu.trainer.trainer import OnPolicyTrainerParams as JParams
from tianshou_tpu.utils.logger.base import BaseLogger as JBaseLogger
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.wrappers import NormObs, merge_rms
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams
from tianshou_tpu_torch.utils.logger.base import BaseLogger
from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E_TRAIN, E_TEST, T, REPEAT, BATCH = 4, 3, 32, 2, 64
ALGO = dict(eps_clip=0.2, ent_coef=0.01, deterministic_eval=True)
COMMON = dict(max_epochs=2, epoch_num_steps=2 * T * E_TRAIN, test_step_num_episodes=3, batch_size=BATCH,
              collection_step_num_env_steps=T, update_step_num_repetitions=REPEAT, verbose=False)
GRAD_STEPS_PER_ROLLOUT = REPEAT * (T * E_TRAIN // BATCH)


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
    algo = JPPO(actor=JDiscreteActor((16, 16), 2), critic=JDiscreteCritic((16, 16)),
                action_space=JCartPole().action_space, optim=JAdam(lr=3e-4, max_grad_norm=0.5), **ALGO)
    train_c, _ = make_collectors(JNormObs(JCartPole()), algo, None, n_train=E_TRAIN, n_test=E_TEST)
    _, test_c = make_collectors(JNormObs(JCartPole(), update_stats=False), algo, None, n_train=E_TRAIN, n_test=E_TEST)
    trainer = JTrainer(algo, train_c, test_c, JParams(**{**COMMON, **kw}))
    return trainer.run(algo.init(jax.random.key(0), jnp.zeros(4)), jax.random.key(1))


def make_port(**kw):
    torch.manual_seed(0)
    algo = PPO(actor=DiscreteActor((16, 16), 2, input_dim=4), critic=DiscreteCritic((16, 16), input_dim=4),
               action_space=CartPole().action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5), **ALGO)
    train_c = DeviceCollector(VectorDeviceEnv(NormObs(CartPole()), E_TRAIN, device="cpu"), algo, None)
    test_c = DeviceCollector(VectorDeviceEnv(NormObs(CartPole(), update_stats=False), E_TEST, device="cpu"), algo, None)
    return OnPolicyTrainer(algo, train_c, test_c, OnPolicyTrainerParams(**{**COMMON, **kw})), algo.init("cpu")


def run_port(**kw):
    trainer, ts = make_port(**kw)
    return trainer.run(ts, torch.Generator().manual_seed(1))


def test_logger_writes_and_counters_match_jax():
    res, writes, ckpts = {}, {}, {"jax": [], "port": []}
    for side, run, base in (("jax", run_jax, JBaseLogger), ("port", run_port, BaseLogger)):
        logger = recorder(base)
        res[side] = run(logger=logger, save_checkpoint_fn=lambda *a, c=ckpts[side]: c.append(a[:3]))
        writes[side] = logger.writes
    assert keys_of(writes["port"]) == keys_of(writes["jax"])
    kinds = [w[0] for w in writes["port"]]
    assert kinds.count("train/env_step") == kinds.count("update/gradient_step") == 4
    assert kinds.count("test/env_step") == kinds.count("info/epoch") == 2
    for side in ("jax", "port"):
        r = res[side]
        assert (r.env_step, r.gradient_step, r.epochs) == (4 * T * E_TRAIN, 4 * GRAD_STEPS_PER_ROLLOUT, 2)
        assert ckpts[side] == [(1, 256, 8), (2, 512, 16)]
    update = [d for t, _, d in writes["port"] if t == "update/gradient_step"]
    assert all(d["update/n_grad_steps"] == GRAD_STEPS_PER_ROLLOUT for d in update)
    assert set(res["port"].timing) == {"collect", "update", "test"}
    for _, _, data in writes["port"]:
        assert all(np.isfinite(v) for v in data.values())
    assert int(res["port"].train_state.step) == res["port"].gradient_step
    assert res["port"].buf_state is None and set(res["port"].last_chunk_stats.keys()) >= {"loss", "approx_kl"}


def test_stop_fn_and_test_in_train_stop_as_jax():
    for r in (run_jax(stop_fn=lambda r: True), run_port(stop_fn=lambda r: True)):
        assert (r.epochs, r.env_step, r.gradient_step) == (1, 2 * T * E_TRAIN, 2 * GRAD_STEPS_PER_ROLLOUT)
    for r in (run_jax(stop_fn=lambda r: True, test_in_train=True),
              run_port(stop_fn=lambda r: True, test_in_train=True)):
        assert (r.epochs, r.env_step, r.gradient_step) == (1, T * E_TRAIN, 0)


def test_test_phase_runs_under_the_pooled_train_statistics():
    trainer, ts = make_port()
    handed = []
    collect_episodes = trainer.test_collector.collect_episodes

    def recording(*args, rms=None, **kw):
        want = merge_rms(trainer._cstate.env_state.rms)
        out = collect_episodes(*args, rms=rms, **kw)
        test_rms = [x.clone() for x in trainer.test_collector._episodes.cstate.env_state.rms]  # the next phase rewrites them
        handed.append((rms, want, test_rms))
        return out

    trainer.test_collector.collect_episodes = recording
    trainer.run(ts, torch.Generator().manual_seed(1))
    assert len(handed) == 2
    for rms, want, test_rms in handed:
        for got, w, slots in zip(rms, want, test_rms):
            assert torch.equal(got, w)
            assert torch.equal(slots, w.expand_as(slots))  # frozen test statistics: still the handed ones
    assert float(handed[1][1].count) > float(handed[0][1].count) > E_TRAIN * 2 * T


def test_train_fn_checkpoints_and_resume(tmp_path):
    seen = []
    trainer, ts = make_port(train_fn=lambda epoch, step: seen.append((epoch, step)) or {"beta": 0.5 * epoch})
    res = trainer.run(ts, torch.Generator().manual_seed(1))
    assert seen == [(1, 0), (1, 128), (2, 256), (2, 384)]
    assert float(res.train_state.hparams["beta"]) == 1.0
    first = run_port(logger=TensorboardLogger(log_dir=str(tmp_path)), max_epochs=1)
    assert (first.env_step, first.gradient_step, first.epochs) == (256, 8, 1)
    trainer, ts = make_port(logger=TensorboardLogger(log_dir=str(tmp_path)), resume_from_log=True)
    assert (trainer.start_epoch, trainer.env_step, trainer.gradient_step) == (1, 256, 8)
    res = trainer.run(ts, torch.Generator())
    assert (res.env_step, res.gradient_step, res.epochs) == (512, 16, 2)
