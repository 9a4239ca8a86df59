"""What the rest of the Atari scripts build against what the JAX scripts build (the method of
``tests/test_torch_examples_builders.py``).

- ``atari_{c51,qrdqn,iqn,fqf,sac}`` through ``atari/_runner.py:run_offpolicy``: the parsed options, the
  algorithm's class and every scalar hyper-parameter, its optimizers, the nets' fields and parameter sizes, then
  the ``OffPolicyTrainer`` each runner assembles on the catch game (env counts, ring, trainer parameters,
  ``train_fn`` over the whole ε schedule and ``stop_fn``).
- ``atari_dqn``'s real-game branch, with ``make_atari_env`` stubbed in both packages to a game of 6 actions: the
  DQN, its nets, the host ring (``ignore_obs_next``) and the ``HostOffPolicyTrainer`` of 10 test envs and
  100,000-step epochs. Without ALE the JAX script runs ``bench.py`` and the port's trains the same DQN (3
  actions) on the catch game through ``_runner`` (the departure ``examples_torch/README.md`` states); that
  trainer is held to ``_runner``'s defaults here.
"""

import types

import pytest

from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from tests.test_torch_examples_builders import (
    _capture,
    _eps_schedules_agree,
    abstract_jax_init,
    assert_same_net_fields,
    assert_same_nets,
    assert_same_trainers,
    check_atari_script,
    jtrainer,
    run_jax_script,
    run_port_script,
    ttrainer,
)
from tests.test_torch_examples_cli import port_module
from tests.test_torch_highlevel import assert_same_hyperparameters

OFF_POLICY = ["atari_c51", "atari_qrdqn", "atari_iqn", "atari_fqf", "atari_sac"]


@pytest.mark.parametrize("script", OFF_POLICY)
def test_the_off_policy_atari_scripts_build_the_jax_algorithm_and_trainer(script, monkeypatch):
    check_atari_script(script, "run_offpolicy", "OffPolicyTrainer", monkeypatch)


class _StubGame:
    """A real game's place where ALE is absent: only its action count is read while the run is built."""

    action_space = types.SimpleNamespace(n=6)

    def close(self):
        pass


def test_atari_dqn_builds_the_jax_host_run_on_a_real_game(monkeypatch):
    import tianshou_tpu.env.atari as jatari
    import tianshou_tpu_torch.env.atari as tatari
    from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
    from tianshou_tpu.data.buffer.base import ReplayBuffer as JReplayBuffer
    from tianshou_tpu_torch.data.buffer.base import ReplayBuffer

    for module in (jatari, tatari):
        monkeypatch.setattr(module, "make_atari_env", lambda task, **kw: _StubGame())
    abstract_jax_init(monkeypatch, JDQN)
    # the 100,000-frame rings are compared by their layout
    monkeypatch.setattr(JReplayBuffer, "init", lambda self, ex: None)
    monkeypatch.setattr(ReplayBuffer, "init", lambda self, ex, device=None: None)
    _capture(monkeypatch, jtrainer.HostOffPolicyTrainer, "run")
    (jt, jts, *_), _ = run_jax_script("atari/atari_dqn.py", monkeypatch, lambda s: None)
    _capture(monkeypatch, ttrainer.HostOffPolicyTrainer, "run")
    (tt, tts, *_), _ = run_port_script("atari/atari_dqn.py")
    assert_same_hyperparameters(jt.algo, tt.algo)
    assert_same_net_fields(jt.algo, tt.algo)
    assert_same_nets(jts, tts)
    assert_same_trainers(jt, tt)
    _eps_schedules_agree(tt.params, jt.params)
    assert tt.algo.action_space.n == 6 and tt.buffer.ignore_obs_next and len(tt.test_collector.venv) == 10


def test_atari_dqn_without_ale_trains_the_same_dqn_on_the_catch_game(monkeypatch):
    """The departure: the port's fallback builds the host branch's DQN at the catch game's 3 actions, and runs it
    through ``_runner._run_offpolicy_device`` with ``_runner``'s defaults for what its parser lacks."""
    from tianshou_tpu_torch.data.buffer.base import ReplayBuffer

    tmod = port_module("atari/atari_dqn.py")
    monkeypatch.setattr(ReplayBuffer, "init", lambda self, ex, device=None: None)
    _capture(monkeypatch, ttrainer.OffPolicyTrainer, "run")
    (tt, _, *_), _ = run_port_script("atari/atari_dqn.py")
    want = tmod.make_algo(tmod.build_parser().parse_args([]), 3)
    assert_same_hyperparameters(want, tt.algo)
    defaults = tmod._runner.parse_args([])
    p = tt.params
    assert (p.max_epochs, p.epoch_num_steps, p.batch_size, p.start_steps) == (
        100, defaults.epoch_num_steps, defaults.batch_size, defaults.start_steps)
    assert (tt.train_collector.venv.num_envs, tt.buffer.capacity * tt.buffer.num_envs) == (10, 100_000)
    assert type(tt.train_collector.venv.env.env).__name__ == "SyntheticAtari"
