"""The port's offline trainer and the offline family's namespace, against
the JAX package.

- An epoch of ``OfflineTrainer`` is ``update_step_num_gradient_steps_per_epoch``
  calls of ``algo.update`` with the trainer's generator: bursts of
  ``OfflineTrainer.BURST`` and one of the remainder, weights and
  stats bit-identical to the plain loop on the CPU (the same operations in
  the same order).
- Both trainers train ``ImitationLearning(Net)`` from rings filled with the
  same transitions and test on ``MoveToRightEnv(size=5,
  max_episode_steps=3)``, whose episodes all end at the third step whatever
  the policy does: the same logger writes (kinds, steps and keys, in order),
  the same ``save_checkpoint_fn`` calls, ``gradient_step``, ``epochs``,
  ``env_step`` 0 and ``timing`` empty; ``stop_fn`` stops both after the
  first epoch.
- Every offline, imitation and model-based class is in the port's
  namespaces with the JAX class's ``run_mode``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tianshou_tpu
import tianshou_tpu.algorithm as jalgorithms
import tianshou_tpu_torch
import tianshou_tpu_torch.algorithm as talgorithms
from tianshou_tpu.algorithm.imitation.bc import ImitationLearning as JBC
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.collector import DeviceCollector as JCollector
from tianshou_tpu.env.core import VectorDeviceEnv as JVectorEnv
from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRightEnv
from tianshou_tpu.models.mlp import Net as JNet
from tianshou_tpu.trainer.trainer import OfflineTrainer as JOfflineTrainer
from tianshou_tpu.trainer.trainer import OfflineTrainerParams as JParams
from tianshou_tpu.utils.logger.base import BaseLogger as JBaseLogger
from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.testing import MoveToRightEnv
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams
from tianshou_tpu_torch.utils.logger.base import BaseLogger
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, C, STEPS, E_TEST = 2, 16, 12, 3
COMMON = dict(max_epochs=3, update_step_num_gradient_steps_per_epoch=5, batch_size=8, test_step_num_episodes=4,
              verbose=False)


def _rows():
    rng = np.random.default_rng(0)
    return [dict(obs=rng.integers(0, 5, (E, 1)).astype(np.float32), act=rng.integers(0, 2, E).astype(np.int32),
                 rew=rng.standard_normal(E).astype(np.float32), terminated=rng.random(E) < 0.2,
                 truncated=np.zeros(E, bool), obs_next=rng.integers(0, 5, (E, 1)).astype(np.float32))
            for _ in range(STEPS)]


def _example(jax_side):
    ex = dict(obs=np.zeros(1, np.float32), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False), obs_next=np.zeros(1, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__(train_interval=1, test_interval=1, update_interval=1, info_interval=1)
            self.writes = []

        def write(self, step_type, step, data):
            self.writes.append((step_type, int(step), tuple(sorted(data))))

    return Recorder()


def run_jax(**kw):
    buffer = JVRB(E * C, E)
    state = buffer.init(_example(True))
    for step in _rows():
        state, _ = buffer.add(state, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
    env = JMoveToRightEnv(size=5, max_episode_steps=3)
    algo = JBC(model=JNet((16,), 2), action_space=env.action_space, optim=JAdam(lr=1e-3))
    test = JCollector(JVectorEnv(env, E_TEST), algo, None)
    trainer = JOfflineTrainer(algo, buffer, test, JParams(**{**COMMON, **kw}))
    return trainer.run(algo.init(jax.random.key(0), jnp.zeros(1)), state, jax.random.key(1))


def make_port(**kw):
    torch.manual_seed(0)
    buffer = VectorReplayBuffer(E * C, E)
    state = buffer.init(_example(False), device="cpu")
    for step in _rows():
        buffer.add(state, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    env = MoveToRightEnv(size=5, max_episode_steps=3)
    algo = ImitationLearning(model=Net((16,), 2, input_dim=1), action_space=env.action_space,
                             optim=AdamOptimizerFactory(lr=1e-3))
    test = DeviceCollector(VectorDeviceEnv(env, E_TEST, device="cpu"), algo, None)
    return OfflineTrainer(algo, buffer, test, OfflineTrainerParams(**{**COMMON, **kw})), algo, state


def run_port(**kw):
    trainer, algo, state = make_port(**kw)
    return trainer.run(algo.init("cpu"), state, torch.Generator().manual_seed(1))


def test_logger_writes_and_counters_match_jax():
    calls = {"jax": [], "port": []}
    res = {}
    for side, run, base in (("jax", run_jax, JBaseLogger), ("port", run_port, BaseLogger)):
        logger = recorder(base)
        res[side] = run(logger=logger, save_checkpoint_fn=lambda *a, c=calls[side]: c.append(a[:3]))
        res[side + "_writes"] = logger.writes
    assert res["port_writes"] == res["jax_writes"]
    kinds = [w[0] for w in res["port_writes"]]
    assert kinds.count("update/gradient_step") == kinds.count("info/epoch") == 3
    assert kinds.count("test/env_step") == 1  # every test phase logs at env_step 0: the logger writes the first
    assert calls["port"] == calls["jax"] == [(1, 0, 5), (2, 0, 10), (3, 0, 15)]
    for side in ("jax", "port"):
        r = res[side]
        assert (r.env_step, r.gradient_step, r.epochs, r.timing) == (0, 15, 3, {})
        assert r.best_reward == r.best_score == 0.0  # every test episode: 3 steps, reward 0 or 1 at the end
    assert int(res["port"].train_state.step) == 15


@pytest.mark.parametrize("stop", [True, False])
def test_stop_fn_stops_after_the_first_epoch(stop):
    results = [run(stop_fn=lambda r: stop) for run in (run_jax, run_port)]
    for r in results:
        assert (r.epochs, r.gradient_step, r.env_step) == ((1, 5, 0) if stop else (3, 15, 0))


@pytest.mark.parametrize("n,k", [(10, 4), (8, 4), (3, 100), (100, 100)])
def test_an_epoch_is_n_updates_in_bursts_of_k(n, k):
    """The epoch's bursts cover n; weights, the step count and every update's stats are those of n
    plain ``algo.update`` calls from the same generator state."""
    trainer, algo, state = make_port(max_epochs=1, update_step_num_gradient_steps_per_epoch=n)
    trainer.BURST = k
    trainer.test_collector = None  # no test phase
    assert trainer.bursts() == [k] * (n // k) + ([n % k] if n % k else []) and sum(trainer.bursts()) == n
    ts = algo.init("cpu")
    plain = algo.init("cpu")
    plain.model.load_state_dict(ts.model.state_dict())
    res = trainer.run(ts, state, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    stats = [algo.update(plain, trainer.buffer, state, g, 8)[2].loss for _ in range(n)]
    assert all(torch.equal(a, b) for a, b in zip(ts.model.parameters(), plain.model.parameters()))
    assert int(ts.step) == int(plain.step) == res.gradient_step == n
    assert torch.equal(res.last_chunk_stats.loss, torch.stack(stats))
    assert res.update_stats["loss"] == pytest.approx(float(torch.stack(stats).mean()))


def test_offline_crr_trains_over_a_second_run_with_the_same_programs():
    """A second ``run`` continues from the first's state and counters (the programs it built stay)."""
    buffer = VectorReplayBuffer(E * C, E)
    state = buffer.init(_example(False), device="cpu")
    for step in _rows():
        buffer.add(state, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    algo = DiscreteCRR(actor=DiscreteActor((8,), 2, input_dim=1), critic=DiscreteCritic((8,), 2, input_dim=1),
                       action_space=MoveToRightEnv().action_space, target_update_freq=3)
    trainer = OfflineTrainer(algo, buffer, None, OfflineTrainerParams(max_epochs=2, batch_size=8,
                                                                      update_step_num_gradient_steps_per_epoch=7,
                                                                      verbose=False))
    trainer.BURST = 3
    ts = algo.init("cpu")
    g = torch.Generator().manual_seed(0)
    first = trainer.run(ts, state, g)
    trainer.params.max_epochs = 3
    trainer.start_epoch = first.epochs
    second = trainer.run(ts, state, g)
    assert (first.gradient_step, second.gradient_step, second.epochs, int(ts.step)) == (14, 21, 3, 21)
    assert set(second.last_chunk_stats.keys()) == {"loss", "actor_loss", "critic_loss"}
    assert second.last_chunk_stats.loss.shape == (7,) and bool(torch.isfinite(second.last_chunk_stats.loss).all())


def test_the_namespaces_hold_the_offline_family():
    """Every JAX algorithm, the multi-agent ones included, and the offline trainer, importable from the port's
    namespaces, each offline and model-based class with the JAX class's ``run_mode``."""
    missing = set(jalgorithms.__all__) - set(talgorithms.__all__)
    assert missing == set()
    assert set(tianshou_tpu.__all__) == set(tianshou_tpu_torch.__all__)
    for name in ("ImitationLearning", "DiscreteBCQ", "DiscreteCQL", "DiscreteCRR", "TD3BC", "BCQ", "CQL", "GAIL",
                 "ICMOffPolicyWrapper", "ICMOnPolicyWrapper", "PSRL", "OfflineAlgorithm", "OffPolicyAlgorithm",
                 "OnPolicyAlgorithm"):
        assert getattr(talgorithms, name).run_mode == getattr(jalgorithms, name).run_mode, name
