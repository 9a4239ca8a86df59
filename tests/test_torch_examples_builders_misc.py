"""What the offline, inverse, model-based, multi-agent, Box2D and the other self-built scripts build against what
the JAX scripts build (the method of ``tests/test_torch_examples_builders.py``).

- ``offline/_gather.py``'s scripts (``{td3_bc,bcq,il}_pendulum``, ``discrete_{bcq,cql,crr}_cartpole``): the
  behavior run and the dataset's collect stubbed in both packages (the run hands its train state back, the collect
  counts two zero rows a ring as written), and the behavior trainer (SAC or DQN) and the ``OfflineTrainer``
  recorded. ``d4rl_bcq`` reads one small d4rl-layout file written here (``--dataset``), so neither side
  synthesizes one.
- ``inverse/irl_gail`` over the same stubbed gathering: GAIL and its ``OnPolicyTrainer``.
- The scripts that build their own trainer: ``continuous/{sac_pendulum,ddpg_her_goalreach}``,
  ``discrete/ppo_cartpole_hl`` (the Experiment API), ``modelbased/psrl`` and ``box2d/*``. The Box2D host scripts
  take ``--num-envs 2`` (an option, held equal by the options' test), and their ``SubprocVectorEnv`` is the
  in-process ``DummyVectorEnv`` in both packages for the build, so that no worker process starts.
- ``marl/*``: the first collect of the self-play recorded in both packages (the ``MultiAgentOffPolicyAlgorithm``
  over two DQNs, the ring, 8 envs and the 500-step prefill).

Held equal, as there: the algorithm's class, every scalar hyper-parameter and its optimizers, the nets' fields and
parameter sizes, the ring's layout, the env counts and every trainer parameter.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_builders import (
    _capture,
    abstract_jax_init,
    assert_same_buffer,
    assert_same_trainers,
    check_trained_script,
    jtrainer,
    run_jax_script,
    run_port_script,
    ttrainer,
)
from tests.test_torch_highlevel import assert_same_hyperparameters

MODELFREE, IMITATION = "tianshou_tpu.algorithm.modelfree", "tianshou_tpu.algorithm.imitation"


def stub_gathering(monkeypatch) -> list:
    """The behavior run hands its train state back and the dataset's collect counts two zero rows of each ring as
    written, in both packages;
    returns the list the behavior trainers are recorded in (JAX's first)."""
    import tianshou_tpu.data.collector as jcollector
    import tianshou_tpu_torch.data.collector as tcollector
    from tianshou_tpu.algorithm.modelfree.dqn import DQN
    from tianshou_tpu.algorithm.modelfree.sac import SAC

    gathered = []
    for trainer_mod in (jtrainer, ttrainer):
        monkeypatch.setattr(trainer_mod.OffPolicyTrainer, "run", lambda self, ts, *a: (
            gathered.append(self), SimpleNamespace(best_reward=0.0, train_state=ts))[1])
    # two rows of each ring count as collected (GAIL's init reads an expert row)
    monkeypatch.setattr(jcollector.DeviceCollector, "collect",
                        lambda self, ts, cs, bs, *a, **k: (cs, bs._replace(size=bs.size + 2), None))
    monkeypatch.setattr(tcollector.DeviceCollector, "collect",
                        lambda self, ts, cs, bs, *a, **k: (cs, (bs.size.add_(2), bs)[1], None))
    for cls in (SAC, DQN):
        abstract_jax_init(monkeypatch, cls)
    return gathered


OFFLINE = {  # script: the JAX offline algorithm
    "offline/td3_bc_pendulum.py": f"{IMITATION}.td3_bc:TD3BC",
    "offline/bcq_pendulum.py": f"{IMITATION}.bcq:BCQ",
    "offline/il_pendulum.py": f"{IMITATION}.bc:ImitationLearning",
    "offline/discrete_bcq_cartpole.py": f"{IMITATION}.discrete_bcq:DiscreteBCQ",
    "offline/discrete_cql_cartpole.py": f"{IMITATION}.discrete_cql:DiscreteCQL",
    "offline/discrete_crr_cartpole.py": f"{IMITATION}.discrete_crr:DiscreteCRR",
}


@pytest.mark.parametrize("rel", list(OFFLINE))
def test_the_offline_scripts_build_the_jax_behavior_run_and_offline_trainer(rel, monkeypatch):
    gathered = stub_gathering(monkeypatch)
    (jt, _), (tt, _) = check_trained_script(rel, "OfflineTrainer", OFFLINE[rel], monkeypatch)
    (jg, tg) = gathered
    assert_same_hyperparameters(jg.algo, tg.algo)
    assert_same_trainers(jg, tg)
    assert_same_buffer(jt.buffer, tt.buffer)  # the dataset's ring


def _write_d4rl(path, rows: int = 64) -> None:
    import h5py

    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for key, shape, dtype in (("observations", (rows, 3), np.float32), ("actions", (rows, 1), np.float32),
                                  ("rewards", (rows,), np.float32), ("next_observations", (rows, 3), np.float32)):
            f.create_dataset(key, data=rng.standard_normal(shape).astype(dtype))
        f.create_dataset("terminals", data=np.zeros(rows, bool))
        f.create_dataset("timeouts", data=(np.arange(rows) % 16) == 15)


def test_d4rl_bcq_builds_the_jax_algorithm_and_trainer_over_one_file(monkeypatch, tmp_path):
    pytest.importorskip("h5py")
    path = tmp_path / "pendulum_d4rl.hdf5"
    _write_d4rl(path)
    (jt, _), (tt, _) = check_trained_script("offline/d4rl_bcq.py", "OfflineTrainer", f"{IMITATION}.bcq:BCQ",
                                            monkeypatch, ("--dataset", str(path)))
    assert_same_buffer(jt.buffer, tt.buffer)


def test_irl_gail_builds_the_jax_algorithm_and_trainer(monkeypatch):
    gathered = stub_gathering(monkeypatch)
    check_trained_script("inverse/irl_gail.py", "OnPolicyTrainer", f"{IMITATION}.gail:GAIL", monkeypatch)
    assert_same_trainers(*gathered)


SELF_BUILT = {  # script: (its trainer's class, the JAX algorithm, the arguments after both scripts' names)
    "continuous/sac_pendulum.py": ("OffPolicyTrainer", f"{MODELFREE}.sac:SAC", ()),
    "continuous/ddpg_her_goalreach.py": ("OffPolicyTrainer", f"{MODELFREE}.ddpg:DDPG", ()),
    "discrete/ppo_cartpole_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.ppo:PPO", ()),
    "modelbased/psrl.py": ("OnPolicyTrainer", "tianshou_tpu.algorithm.modelbased.psrl:PSRL", ()),
    "box2d/acrobot_dualdqn.py": ("OffPolicyTrainer", f"{MODELFREE}.dqn:DQN", ()),
    "box2d/mcc_sac.py": ("OffPolicyTrainer", f"{MODELFREE}.sac:SAC", ()),
    "box2d/lunarlander_dqn.py": ("HostOffPolicyTrainer", f"{MODELFREE}.dqn:DQN", ("--num-envs", "2")),
    "box2d/bipedal_sac.py": ("HostOffPolicyTrainer", f"{MODELFREE}.sac:SAC", ("--num-envs", "2")),
    "box2d/bipedal_bdq.py": ("HostOffPolicyTrainer", f"{MODELFREE}.bdqn:BDQN", ("--num-envs", "2")),
}


@pytest.mark.parametrize("rel", list(SELF_BUILT))
def test_the_self_built_scripts_build_the_jax_algorithm_and_trainer(rel, monkeypatch, tmp_path):
    trainer_cls, jalgo, argv = SELF_BUILT[rel]
    if rel.startswith("box2d/") and trainer_cls.startswith("Host"):
        pytest.importorskip("Box2D")
        import tianshou_tpu.env.venvs as jvenvs
        import tianshou_tpu_torch.env.venvs as tvenvs

        for venvs in (jvenvs, tvenvs):
            monkeypatch.setattr(venvs, "SubprocVectorEnv", venvs.DummyVectorEnv)
    monkeypatch.chdir(tmp_path)  # an experiment's persistence writes under ./log
    (jt, _), (tt, _) = check_trained_script(rel, trainer_cls, jalgo, monkeypatch, argv)
    if trainer_cls.startswith("Host"):
        assert type(tt.train_collector.venv).__name__ == "DummyVectorEnv" and len(tt.train_collector.venv) == 2


@pytest.mark.parametrize("rel", ["marl/tictactoe_selfplay.py", "marl/pettingzoo_tictactoe_dqn.py"])
def test_the_self_play_scripts_build_the_jax_dispatcher_ring_and_prefill(rel, monkeypatch):
    if "pettingzoo" in rel:
        pytest.importorskip("pettingzoo")
    import tianshou_tpu.data.host_collector as jhost
    import tianshou_tpu_torch.data.host_collector as thost
    from tianshou_tpu.algorithm.multiagent.marl import MultiAgentOffPolicyAlgorithm

    abstract_jax_init(monkeypatch, MultiAgentOffPolicyAlgorithm)
    _capture(monkeypatch, jhost.HostCollector, "collect")
    (jc, _, _), jkw = run_jax_script(rel, monkeypatch, lambda s: None)
    _capture(monkeypatch, thost.HostCollector, "collect")
    (tc, tts, _), tkw = run_port_script(rel)
    assert jkw == tkw == {"n_step": 500}
    assert_same_hyperparameters(jc.algo, tc.algo)
    for i, (ja, ta) in enumerate(zip(jc.algo.algorithms, tc.algo.algorithms)):
        assert_same_hyperparameters(ja, ta, f"agent{i}")
        assert type(ta.model).__name__ == type(ja.model).__name__ == "BoardQNet"
    assert_same_buffer(jc.buffer, tc.buffer)
    assert len(tc.venv) == len(jc.venv) == 8
    assert type(tc.venv.workers[0].env).__name__ == type(jc.venv.workers[0].env).__name__
