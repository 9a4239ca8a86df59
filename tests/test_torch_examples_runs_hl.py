"""The nine high-level MuJoCo scripts (``mujoco/_hl.py``, the Experiment API), each through its own ``main`` on the
CPU at a tiny size (``tests/_torch_example_runs.py``): Hopper, 2 envs, one epoch of 16 steps, a 200-row ring after
an 8-step prefill. The on-policy scripts' collect of 2,048 steps a env and 10 passes (their training config's; the
scripts give no option for them) are cut to 8 steps and one pass in the trainer; a test phase counts 2 episodes
(from 10), and an episode is truncated at 16 steps (from 1,000), one test chunk. Each experiment writes its
persistence under a temporary directory.
"""

import pytest

from tests._torch_example_runs import Cut, assert_finite_run, run_main
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ARGV = ("--task", "Hopper", "--epochs", "1", "--epoch-num-steps", "16", "--num-envs", "2", "--buffer-size", "200",
        "--start-steps", "8")
OFF = dict(test_step_num_episodes=2)
ON = dict(test_step_num_episodes=2, collection_step_num_env_steps=8, update_step_num_repetitions=1)
SHORT_EPISODE = {"tianshou_tpu_torch.env.mujoco.base:MujocoEnv.max_episode_steps": 16}
RUNS = {f"mujoco/mujoco_{a}_hl.py": Cut(ARGV, OFF if a in ("sac", "td3", "ddpg", "redq") else ON, sets=SHORT_EPISODE)
        for a in ("sac", "td3", "ddpg", "redq", "ppo", "reinforce", "a2c", "npg", "trpo")}


@pytest.mark.parametrize("rel", list(RUNS))
def test_a_high_level_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)  # the experiment's persistence writes under ./log
    rec = run_main(rel, RUNS[rel], monkeypatch)
    assert_finite_run(rec)
    (trainer,) = rec.trainers
    assert rec.result.epochs == 1 and rec.result.gradient_step > 0
    assert trainer.train_collector.venv.num_envs == 2
    assert "best_reward=" in capsys.readouterr().out
