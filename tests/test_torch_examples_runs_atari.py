"""The Atari scripts not yet run end to end, each through its own ``main`` on the CPU at a tiny size
(``tests/_torch_example_runs.py``): the catch game over 2 envs, one epoch of 40 env steps after a 40-step prefill,
a 200-row ring and batches of 4 (``atari_dqn``, whose parser has no option for the epoch, the prefill or the batch,
gets the epoch and the prefill in its trainer). The catch game's episode is cut from 200 steps to 16, so that a
test phase is one chunk of 16 steps of the 8 test envs. ``atari_ppo`` collects 32 steps a env (from 128) in its
trainer.
"""

import pytest

from tests._torch_example_runs import Cut, assert_finite_run, run_main
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SHORT_GAME = {"examples_torch.atari._runner:SyntheticAtari.max_episode_steps": 16}
TINY = ("--epochs", "1", "--epoch-num-steps", "40", "--start-steps", "40", "--num-envs", "2", "--buffer-size", "200",
        "--batch-size", "4")
RUNS = {
    "atari/atari_dqn.py": Cut(("--epochs", "1", "--num-envs", "2", "--buffer-size", "200"),
                              trainer=dict(epoch_num_steps=40, start_steps=40), sets=SHORT_GAME),
    "atari/atari_c51.py": Cut(TINY, sets=SHORT_GAME),
    "atari/atari_qrdqn.py": Cut(TINY, sets=SHORT_GAME),
    "atari/atari_iqn.py": Cut(TINY, sets=SHORT_GAME),
    "atari/atari_fqf.py": Cut(TINY, sets=SHORT_GAME),
    "atari/atari_sac.py": Cut(TINY, sets=SHORT_GAME),
    "atari/atari_ppo.py": Cut(("--epochs", "1", "--epoch-num-steps", "64", "--num-envs", "2", "--batch-size", "64"),
                              trainer=dict(collection_step_num_env_steps=32), sets=SHORT_GAME),
}


@pytest.mark.parametrize("rel", list(RUNS))
def test_an_atari_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, capsys):
    rec = run_main(rel, RUNS[rel], monkeypatch)
    assert_finite_run(rec)
    (trainer,) = rec.trainers
    res = rec.result
    assert res.epochs == 1 and res.gradient_step > 0 and res.env_step > 0
    assert type(trainer.train_collector.venv.env.env).__name__ == "SyntheticAtari"
    out = capsys.readouterr().out
    assert "the synthetic catch game (SyntheticAtari)" in out and "best_reward=" in out
