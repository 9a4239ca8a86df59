"""What the rest of the MuJoCo scripts build against what the JAX scripts build (the method of
``tests/test_torch_examples_builders.py``).

- ``mujoco_{td3,ddpg,redq}`` (``mujoco/_runner.py:run_offpolicy``) and ``mujoco_{reinforce,a2c,npg}``
  (``run_onpolicy``) at their defaults: the algorithm's class, scalar hyper-parameters and optimizers, the nets'
  fields and parameter sizes, the env counts, the ring and the trainer's parameters.
- The eight ``mujoco_*_hl.py`` scripts not yet held (``mujoco/_hl.py``): the parsed options, the builder's class,
  the training config, the params and every factory, then the algorithm and the trainer each builder's
  experiment assembles.
- ``goal_her_ddpg`` with and without ``--no-her``: DDPG over the goal nets, the HER ring (horizon 60, future_k 8,
  that is future_p 7/8) or the plain one, and the trainer.
"""

import pytest

from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_builders import check_hl_script, check_trained_script

MODELFREE = "tianshou_tpu.algorithm.modelfree"
RUNNER = {  # script: (its trainer's class, the JAX algorithm)
    "mujoco/mujoco_td3.py": ("OffPolicyTrainer", f"{MODELFREE}.td3:TD3"),
    "mujoco/mujoco_ddpg.py": ("OffPolicyTrainer", f"{MODELFREE}.ddpg:DDPG"),
    "mujoco/mujoco_redq.py": ("OffPolicyTrainer", f"{MODELFREE}.redq:REDQ"),
    "mujoco/mujoco_reinforce.py": ("OnPolicyTrainer", f"{MODELFREE}.reinforce:Reinforce"),
    "mujoco/mujoco_a2c.py": ("OnPolicyTrainer", f"{MODELFREE}.a2c:A2C"),
    "mujoco/mujoco_npg.py": ("OnPolicyTrainer", f"{MODELFREE}.npg:NPG"),
}


@pytest.mark.parametrize("rel", list(RUNNER))
def test_the_runner_scripts_build_the_jax_algorithm_and_trainer(rel, monkeypatch):
    trainer_cls, jalgo = RUNNER[rel]
    (jt, _), (tt, _) = check_trained_script(rel, trainer_cls, jalgo, monkeypatch)
    assert (tt.train_collector.venv.num_envs, tt.test_collector.venv.num_envs) == (
        jt.train_collector.venv.num_envs, jt.test_collector.venv.num_envs)
    if trainer_cls == "OnPolicyTrainer":  # the train envs normalize observations, the test envs read the statistics
        assert type(tt.train_collector.venv.env).__name__ == "NormObs"
        assert tt.train_collector.venv.env.update_stats and not tt.test_collector.venv.env.update_stats


HL = {  # script: (its trainer's class, the JAX algorithm)
    "mujoco/mujoco_td3_hl.py": ("OffPolicyTrainer", f"{MODELFREE}.td3:TD3"),
    "mujoco/mujoco_ddpg_hl.py": ("OffPolicyTrainer", f"{MODELFREE}.ddpg:DDPG"),
    "mujoco/mujoco_redq_hl.py": ("OffPolicyTrainer", f"{MODELFREE}.redq:REDQ"),
    "mujoco/mujoco_ppo_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.ppo:PPO"),
    "mujoco/mujoco_reinforce_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.reinforce:Reinforce"),
    "mujoco/mujoco_a2c_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.a2c:A2C"),
    "mujoco/mujoco_npg_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.npg:NPG"),
    "mujoco/mujoco_trpo_hl.py": ("OnPolicyTrainer", f"{MODELFREE}.trpo:TRPO"),
}


@pytest.mark.parametrize("rel", list(HL))
def test_the_high_level_scripts_build_the_jax_experiment(rel, monkeypatch, tmp_path):
    import importlib

    trainer_cls, jalgo = HL[rel]
    module, cls = jalgo.split(":")
    check_hl_script(rel, trainer_cls, getattr(importlib.import_module(module), cls), monkeypatch, tmp_path)


@pytest.mark.parametrize("argv", [(), ("--no-her",)], ids=["her", "no_her"])
def test_goal_her_ddpg_builds_the_jax_algorithm_ring_and_trainer(argv, monkeypatch):
    (jt, _), (tt, _) = check_trained_script("mujoco/goal_her_ddpg.py", "OffPolicyTrainer", f"{MODELFREE}.ddpg:DDPG",
                                            monkeypatch, argv)
    assert type(tt.buffer).__name__ == ("ReplayBuffer" if argv else "HERReplayBuffer")
    if not argv:
        assert (tt.buffer.horizon, tt.buffer.future_p) == (jt.buffer.horizon, jt.buffer.future_p) == (60, 1 - 1 / 8.0)
    assert tt.test_collector.venv.num_envs == jt.test_collector.venv.num_envs == 20
