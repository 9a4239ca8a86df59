"""The port's loggers, statistics, progress bar and determinism trace
(``tianshou_tpu_torch.utils`` / ``data.stats``), as
``tests/test_utils_infra.py:54-81,160-181`` holds the JAX package's, and the
same calls through both packages' loggers giving the same writes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tianshou_tpu.utils.logger.base import BaseLogger as JBaseLogger
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.data.stats import EpochStats, InfoStats, SequenceSummaryStats, TimingStats
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.utils.determinism import (
    TraceDeterminismTest,
    TraceLogger,
    TraceLoggerContext,
    trace_param_hash,
)
from tianshou_tpu_torch.utils.logger import BaseLogger, CurveLogger, DataScope, LazyLogger
from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger
from tianshou_tpu_torch.utils.print import DataclassPPrintMixin
from tianshou_tpu_torch.utils.progress import progress_bar
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def test_sequence_summary():
    s = SequenceSummaryStats.from_sequence([1, 2, 3])
    assert (s.mean, s.max, s.min) == (2.0, 3.0, 1.0)
    assert SequenceSummaryStats.from_sequence([]).mean == 0.0
    info = InfoStats(gradient_step=3, timing=TimingStats(test_time=1.5))
    assert EpochStats(epoch=2, info_stat=info).info_stat.timing.test_time == 1.5


def test_tensorboard_logger(tmp_path):
    lg = TensorboardLogger(log_dir=str(tmp_path), train_interval=5)
    lg.log_train_data({"train/reward": 1.0}, step=0)
    lg.log_train_data({"train/reward": 2.0}, step=3)  # below interval: skipped
    lg.log_train_data({"train/reward": 3.0}, step=10)
    lg.save_data(epoch=2, env_step=10, gradient_step=7)
    lg2 = TensorboardLogger(log_dir=str(tmp_path))
    assert lg2.restore_data() == (2, 10, 7)
    assert (lg2.last_log_train_step, lg2.last_log_update_step) == (10, 7)
    assert any(f.startswith("events") for f in os.listdir(tmp_path))
    LazyLogger().log_train_data({"x": 1}, 0)  # no-op
    assert TensorboardLogger(log_dir=str(tmp_path / "fresh")).restore_data() == (0, 0, 0)


def test_tensorboard_logger_reads_back_its_event_files(tmp_path, monkeypatch):
    """The logger writes through ``torch.utils.tensorboard``, which needs only the ``tensorboard`` package: the
    scalars read back from its event files, and the counters from its sidecar."""
    import sys

    pytest.importorskip("tensorboard")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # TensorBoard's own stand-in; TensorFlow's import is slow
    lg = TensorboardLogger(log_dir=str(tmp_path), test_interval=1)
    assert type(lg.writer).__module__.startswith("torch.utils.tensorboard") and lg.log_dir == str(tmp_path)
    for step, reward in ((0, 1.5), (100, 2.5), (200, -3.0)):
        lg.log_test_data({"test/reward": reward}, step=step)
    lg.save_data(epoch=3, env_step=200, gradient_step=20)
    lg.writer.close()
    assert lg.restore_logged_data()["test/reward"] == [(0, 1.5), (100, 2.5), (200, -3.0)]
    assert TensorboardLogger(log_dir=str(tmp_path)).restore_data() == (3, 200, 20)


def _recorder(base, **intervals):
    class Recorder(base):
        def __init__(self):
            super().__init__(**intervals)
            self.writes = []

        def write(self, step_type, step, data):
            self.writes.append((step_type, step, dict(data)))

    return Recorder()


def test_scope_intervals_match_jax():
    intervals = dict(train_interval=5, test_interval=2, update_interval=3, info_interval=1)
    port, ref = _recorder(BaseLogger, **intervals), _recorder(JBaseLogger, **intervals)
    rng = np.random.default_rng(0)
    for step in np.cumsum(rng.integers(0, 4, 60)):
        for lg in (port, ref):
            lg.log_train_data({"train/reward": float(step)}, int(step))
            lg.log_test_data({"test/reward": 1.0}, int(step))
            lg.log_update_data({"update/loss": 0.5}, int(step))
            lg.log_info_data({"info/x": 2}, int(step))
    assert port.writes == ref.writes
    kinds = {t for t, _, _ in port.writes}
    assert kinds == {"train/env_step", "test/env_step", "update/gradient_step", "info/epoch"}
    trains = [s for t, s, _ in port.writes if t == "train/env_step"]
    assert all(b - a >= 5 for a, b in zip(trains, trains[1:]))
    assert [m.value for m in DataScope] == ["train", "test", "update", "info"]


def test_lazy_and_curve_loggers():
    lazy = LazyLogger()
    lazy.log_test_data({"test/reward": 1.0}, 0)
    assert lazy.restore_data() == (0, 0, 0)
    curve = CurveLogger()
    curve.log_train_data({"train/reward": 5.0}, 10)
    curve.log_test_data({"test/reward": 1.5, "test/length": 3}, 100)
    curve.log_test_data({"test/reward": 2.5}, 200)
    curve.log_test_data({"test/length": 4}, 300)  # no reward: no point
    assert curve.curve == [(100, 1.5), (200, 2.5)]


def test_pprint_mixin(capsys):
    @dataclasses.dataclass
    class Cfg(DataclassPPrintMixin):
        lr: float = 1e-3
        name: str = "dqn"

    text = Cfg().pprints_asdict(exclude_fields=["name"])
    assert text.startswith("Cfg\n" + "-" * 40) and "'lr': 0.001" in text and "name" not in text
    Cfg().pprint_asdict()
    assert "'name': 'dqn'" in capsys.readouterr().out


def test_progress_bar_off_is_a_noop():
    with progress_bar(10, "epoch 1", enabled=False) as bar:
        bar.update(3)
        bar.set_postfix(loss=1.0)
    bar.close()


def test_wandb_logger_needs_wandb():
    from tianshou_tpu_torch.utils.logger.wandb import WandbLogger

    with pytest.raises(ImportError, match="wandb is not installed"):
        WandbLogger(project="p")


def _run_traced(seed):
    torch.manual_seed(seed)
    env = CartPole()
    algo = DQN(model=Net((32, 32), 2, input_dim=4), action_space=env.action_space,
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=2, target_update_freq=50,
               eps_training=0.2)
    ts = algo.init("cpu")
    buffer = VectorReplayBuffer(1024, 4)
    bs = buffer.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0),
                           terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=torch.zeros(4)),
                     device="cpu")
    tc = DeviceCollector(VectorDeviceEnv(env, 4, device="cpu"), algo, buffer)
    gen = torch.Generator().manual_seed(seed)
    cstate = tc.reset(gen)
    with TraceLoggerContext() as tl:
        for _ in range(3):
            _, _, out = tc.collect(ts, cstate, bs, gen, 32)
            TraceLogger.log("collect", lambda: f"done={int(out.done.sum())}")
            algo.update(ts, buffer, bs, gen, 32)
            TraceLogger.log("update", lambda: f"params={trace_param_hash(ts)}")
        trace = tl.get_trace()
    assert not TraceLogger.enabled
    return trace, trace_param_hash(ts)


def test_determinism_same_seed(tmp_path):
    t1, h1 = _run_traced(0)
    t2, h2 = _run_traced(0)
    assert h1 == h2 and len(h1) == 40
    assert t1 == t2 and len(t1) == 9 and t1[0].startswith("collector: n_steps=32 training=True")
    det = TraceDeterminismTest(str(tmp_path))
    det.check("dqn_small", t1)  # the first run creates the snapshot, the second compares
    det.check("dqn_small", t2)
    with pytest.raises(AssertionError, match="determinism trace mismatch"):
        det.check("dqn_small", t1[:-1] + ["update: params=deadbeef"])
    with pytest.raises(FileNotFoundError):
        det.check("missing", t1, create_if_missing=False)


def test_determinism_different_seed():
    _, h1 = _run_traced(0)
    _, h2 = _run_traced(1)
    assert h1 != h2


def test_trace_param_hash_covers_the_target():
    env = CartPole()
    algo = DQN(model=Net((8,), 2, input_dim=4), action_space=env.action_space, target_update_freq=5)
    ts = algo.init("cpu")
    h = trace_param_hash(ts)
    with torch.no_grad():
        next(ts.target.parameters()).add_(1.0)
    assert trace_param_hash(ts) != h
    TraceLogger.log("off", lambda: 1 / 0)  # not evaluated while tracing is off
