"""The MuJoCo scripts not yet run end to end, each through its own ``main`` on the CPU at a tiny size
(``tests/_torch_example_runs.py``).

- ``mujoco/_runner.py``'s scripts and ``mujoco_{td3,ppo}`` on Hopper, the cheapest task here: its episodes end when
  it falls (the physics has no CPU kernel: a vector step takes tens of milliseconds). Off-policy: 2 envs, one epoch
  of 8 steps after an 8-step prefill, batches of 16. On-policy: 2 envs, one epoch of one 8-step rollout, batches of
  16, one pass. In the trainer a test phase counts 2 episodes (from 10), and an episode is truncated at 16 steps
  (from 1,000: an untrained deterministic policy can keep Hopper up for hundreds of steps), one test chunk.
  ``mujoco_ppo --sde`` runs gSDE's branch too.
- ``mujoco_sac --backend host``: the real Gymnasium MuJoCo ``Reacher-v4`` through the host collector and trainer.
- ``goal_her_ddpg`` with and without HER: one epoch, its epoch and prefill cut to 64 steps in its trainer.
- ``plotter``: three seeds' TensorBoard logs written here through the port's logger, plotted; the summary equals
  the JAX package's ``load_and_eval_experiments`` over the same logs. TensorBoard reads the event files through
  its own stand-in for TensorFlow (its fallback where TensorFlow is absent), since TensorFlow's import alone takes
  tens of seconds here.
"""

import dataclasses
import sys

import pytest

from tests._torch_example_runs import Cut, assert_finite_run, run_main
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_cli import port_module

OFF = ("--task", "Hopper", "--epochs", "1", "--epoch-num-steps", "8", "--start-steps", "8", "--num-envs", "2",
       "--batch-size", "16")
ON = ("--task", "Hopper", "--epochs", "1", "--epoch-num-steps", "16", "--num-envs", "2", "--rollout-len", "8",
      "--batch-size", "16", "--repeat", "1")
TEST = dict(test_step_num_episodes=2)  # of the 10 test envs
SHORT_EPISODE = {"tianshou_tpu_torch.env.mujoco.base:MujocoEnv.max_episode_steps": 16}
RUNS = {
    "mujoco/mujoco_td3.py": Cut(OFF, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_ddpg.py": Cut(OFF, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_redq.py": Cut(OFF, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_ppo.py": Cut(ON, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_reinforce.py": Cut(ON, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_a2c.py": Cut(ON, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_npg.py": Cut(ON, TEST, sets=SHORT_EPISODE),
    "mujoco/mujoco_trpo.py": Cut(ON, TEST, sets=SHORT_EPISODE),
    "mujoco/goal_her_ddpg.py": Cut(("--epochs", "1"), trainer=dict(epoch_num_steps=64, start_steps=64)),
}
#: a second run of a script: another branch it takes
BRANCHES = {
    "mujoco_ppo_sde": ("mujoco/mujoco_ppo.py", Cut((*ON, "--sde"), TEST, sets=SHORT_EPISODE)),
    "mujoco_sac_host": ("mujoco/mujoco_sac.py", Cut(("--backend", "host", "--task", "Reacher", "--epochs", "1",
                                                     "--epoch-num-steps", "8", "--start-steps", "8", "--num-envs", "2",
                                                     "--batch-size", "16"), needs=("gymnasium", "mujoco"))),
    "goal_her_ddpg_no_her": ("mujoco/goal_her_ddpg.py", Cut(("--epochs", "1", "--no-her"),
                                                            trainer=dict(epoch_num_steps=64, start_steps=64))),
}


@pytest.mark.parametrize("rel", list(RUNS))
def test_a_mujoco_script_trains_on_the_cpu_through_its_main(rel, monkeypatch):
    rec = run_main(rel, RUNS[rel], monkeypatch)
    assert_finite_run(rec)
    (trainer,) = rec.trainers
    assert rec.result.epochs == 1 and rec.result.gradient_step > 0
    if "--task" in RUNS[rel].argv:
        assert type(trainer.train_collector.venv.env).__name__ in ("Hopper", "NormObs")
        assert trainer.train_collector.venv.num_envs == 2


@pytest.mark.parametrize("name", list(BRANCHES))
def test_a_mujoco_script_branch_trains_on_the_cpu_through_its_main(name, monkeypatch):
    rel, cut = BRANCHES[name]
    rec = run_main(rel, cut, monkeypatch)
    assert_finite_run(rec)
    (trainer,) = rec.trainers
    assert rec.result.gradient_step > 0
    if name == "mujoco_sac_host":
        assert type(trainer).__name__ == "HostOffPolicyTrainer" and len(trainer.train_collector.venv) == 2
    elif name == "mujoco_ppo_sde":
        assert trainer.algo.actor.sde
    else:
        assert type(trainer.buffer).__name__ == "ReplayBuffer"


def test_the_plotter_plots_a_multi_seed_log_directory(tmp_path, capsys, monkeypatch):
    pytest.importorskip("tensorboard")
    pytest.importorskip("matplotlib")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # TensorBoard's stand-in instead
    from tianshou_tpu.evaluation.rliable_evaluation import load_and_eval_experiments as jload
    from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger

    dirs = []
    for seed in range(3):
        d = str(tmp_path / f"seed{seed}")
        logger = TensorboardLogger(log_dir=d, test_interval=1)
        for i, step in enumerate([0, 1000, 2000, 3000]):
            logger.write("test/env_step", step, {"test/reward": float(seed + i * 10) + 0.5 * seed * i})
        logger.writer.close()
        dirs.append(d)
    out = tmp_path / "curve.png"
    summary = port_module("mujoco/plotter.py").main([*dirs, "-o", str(out), "--title", "Hopper"])
    assert out.stat().st_size > 0 and f"wrote {out}" in capsys.readouterr().out
    assert dataclasses.asdict(summary) == dataclasses.asdict(jload(dirs)[4])
    assert summary.n_runs == 3
