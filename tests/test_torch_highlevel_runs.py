"""The port's high-level API run end to end on the CPU (the port only; its
parity with the JAX package is ``tests/test_torch_highlevel.py``).

- Each builder family trains at the small configurations of
  ``tests/test_highlevel.py``, one or a few builders of each (every builder is
  built and acts in ``tests/test_torch_highlevel.py``; SAC, PPO and DQN
  also run on the card in ``chip_smoke.py``): off-policy discrete and
  continuous, on-policy, the offline builders from a dataset, GAIL, BDQN, ICM and PER through the builder, the epoch callbacks
  with the TensorBoard logger factory, the host path (``GymEnvFactory``,
  off- and on-policy) and the MARL builder.
- Persistence: a run with persistence on writes ``best`` (a train state that
  restores bit for bit) and ``experiment.pkl``; ``Experiment.from_directory``
  gives a runnable experiment, also from a lambda env factory.
- The same seed gives the same run (rewards and weights bit for bit); ``watch`` replays the trained policy.
- ``slow``: the DQN and PPO builders to 195 on CartPole
  (``tests/test_highlevel.py:34-68``).
"""

import os

import numpy as np
import pytest
import torch

from tianshou_tpu_torch.data.buffer.base import ReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.env.classic.pendulum import Pendulum
from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
from tianshou_tpu_torch.env.wrappers import ContinuousToDiscrete
from tianshou_tpu_torch.highlevel import experiment as E
from tianshou_tpu_torch.highlevel.config import (
    ExperimentConfig,
    OfflineTrainingConfig,
    OffPolicyTrainingConfig,
    OnPolicyTrainingConfig,
)
from tianshou_tpu_torch.highlevel.params import LRSchedulerFactoryLinear, PPOParams
from tianshou_tpu_torch.utils.determinism import trace_param_hash
from tianshou_tpu_torch.utils.persistence import buffer_from_data, restore_train_state
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = "cpu"


def no_persist(tmp_path=None):
    return ExperimentConfig(seed=0, persistence_enabled=False,
                            persistence_base_dir=str(tmp_path) if tmp_path else "log")


def small_offp():
    return OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=400, buffer_size=2000, num_train_envs=4,
                                   num_test_envs=4, start_timesteps=100, test_step_num_episodes=2, batch_size=32)


def small_onp(**kw):
    return OnPolicyTrainingConfig(**{**dict(max_epochs=1, epoch_num_steps=256, num_train_envs=4, num_test_envs=4,
                                            test_step_num_episodes=2, batch_size=64, collection_step_num_env_steps=32),
                                     **kw})


def pendulum_offp():
    return OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=600, buffer_size=5000, num_train_envs=4,
                                   num_test_envs=4, test_step_num_episodes=2, start_timesteps=200,
                                   start_timesteps_random=False, collection_step_num_env_steps=25)


def pendulum_env():
    return Pendulum()


def c2d_pendulum():
    return ContinuousToDiscrete(Pendulum(), 5)


@pytest.mark.parametrize("name", ["DQNExperimentBuilder", "DiscreteSACExperimentBuilder"])
def test_discrete_offpolicy_builders_train(name):
    r = getattr(E, name)(CartPole, no_persist(), small_offp()).build().run("smoke", device=CPU)
    assert r.env_step >= 400 + 100 and r.gradient_step > 0 and np.isfinite(r.best_reward)


@pytest.mark.parametrize("name", ["TD3ExperimentBuilder"])
def test_continuous_offpolicy_builders_train(name):
    r = getattr(E, name)(pendulum_env, no_persist(), pendulum_offp()).build().run("smoke", device=CPU)
    assert r.env_step >= 800 and r.gradient_step > 0


@pytest.mark.parametrize("name", ["PPOExperimentBuilder", "A2CExperimentBuilder"])
def test_onpolicy_builders_train(name):
    b = getattr(E, name)(CartPole, no_persist(), small_onp())
    if name == "PPOExperimentBuilder":
        b.with_params(PPOParams(lr=3e-4, lr_scheduler=LRSchedulerFactoryLinear(), max_grad_norm=0.5))
    r = b.build().run("smoke", device=CPU)
    assert r.env_step >= 256 and r.gradient_step > 0


def test_bdqn_gail_icm_and_per_through_the_builders():
    r = (E.BDQNExperimentBuilder(c2d_pendulum, no_persist(), small_offp())
         .with_dqn_params(eps_training=0.3, target_update_freq=100).build().run("bdqn", device=CPU))
    assert r.env_step > 0
    rng = np.random.default_rng(0)
    r = (E.GAILExperimentBuilder(pendulum_env, no_persist(), small_onp())
         .with_expert_data(rng.standard_normal((256, 3)).astype(np.float32),
                           rng.uniform(-1, 1, (256, 1)).astype(np.float32))
         .build().run("gail", device=CPU))
    assert r.env_step > 0
    r = E.DQNExperimentBuilder(CartPole, no_persist(), small_offp()).with_dqn_params(eps_training=0.3).with_icm(
        feature_dim=16).build().run("icm", device=CPU)
    assert r.env_step > 0 and "icm_loss" in r.last_chunk_stats
    r = E.PPOExperimentBuilder(CartPole, no_persist(), small_onp()).with_icm(feature_dim=16).build().run("icm_ppo",
                                                                                                        device=CPU)
    assert r.env_step > 0
    r = (E.DQNExperimentBuilder(CartPole, no_persist(), small_offp()).with_dqn_params(eps_training=0.3)
         .with_buffer_factory(lambda n: PrioritizedVectorReplayBuffer(2000, n, alpha=0.6, beta=0.4))
         .build().run("per", device=CPU))
    assert r.env_step > 0 and float(r.buf_state.tree.sum()) > 0 and r.buf_state.tree.shape[0] == 2 * 2048


def _dataset(discrete: bool):
    rng = np.random.default_rng(0)
    n, dim = 512, (4 if discrete else 3)
    act = rng.integers(0, 2, n) if discrete else rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    done = rng.random(n) < 0.05
    return buffer_from_data(
        ReplayBuffer, obs=rng.standard_normal((n, dim)).astype(np.float32), act=act, rew=rng.standard_normal(n).astype(np.float32),
        terminated=done, truncated=np.zeros(n, bool), obs_next=rng.standard_normal((n, dim)).astype(np.float32),
        device=CPU)


@pytest.mark.parametrize("name,discrete", [("CQLExperimentBuilder", False), ("BCQExperimentBuilder", False),
                                           ("ImitationLearningExperimentBuilder", True),
                                           ("DiscreteCRRExperimentBuilder", True)])
def test_offline_builders_train_from_a_dataset(name, discrete):
    training = OfflineTrainingConfig(max_epochs=1, update_step_num_gradient_steps_per_epoch=20, batch_size=64,
                                     num_test_envs=4, test_step_num_episodes=2)
    r = (getattr(E, name)(CartPole if discrete else pendulum_env, no_persist(), training)
         .with_dataset(*_dataset(discrete)).build().run("offline", device=CPU))
    assert r.gradient_step == 20 and r.env_step == 0


def test_callbacks_and_tensorboard_logger_factory(tmp_path):
    from tianshou_tpu_torch.highlevel.logger import LoggerFactoryDefault
    from tianshou_tpu_torch.highlevel.trainer import (
        EpochStopCallbackRewardThreshold,
        EpochTestCallbackDQNSetEps,
        EpochTrainCallbackDQNEpsLinearDecay,
    )

    r = (E.DQNExperimentBuilder(CartPole, no_persist(tmp_path),
                                OffPolicyTrainingConfig(max_epochs=2, epoch_num_steps=1000, num_train_envs=8,
                                                        num_test_envs=4, buffer_size=5000, test_step_num_episodes=4))
         .with_epoch_train_callback(EpochTrainCallbackDQNEpsLinearDecay(1.0, 0.1, 5000))
         .with_epoch_test_callback(EpochTestCallbackDQNSetEps(0.0))
         .with_epoch_stop_callback(EpochStopCallbackRewardThreshold(threshold=10_000))
         .with_logger_factory(LoggerFactoryDefault(log_dir=str(tmp_path / "tb")))
         .build().run("cb_test", device=CPU))
    assert r.env_step >= 2000 and r.epochs == 2
    eps = float(r.train_state.hparams["eps_training"])
    assert abs(eps - (1.0 + min(r.env_step - 80, 5000) / 5000 * (0.1 - 1.0))) < 0.2 and eps < 1.0
    assert float(r.train_state.hparams["eps_inference"]) == 0.0
    tb_dir = tmp_path / "tb" / "cb_test"
    assert tb_dir.exists() and any(tb_dir.iterdir())


def test_host_path_builders_through_gym_env_factory():
    pytest.importorskip("gymnasium")
    from tianshou_tpu_torch.highlevel.env import GymEnvFactory, VectorEnvType

    r = (E.DQNExperimentBuilder(GymEnvFactory("CartPole-v1", venv_type=VectorEnvType.DUMMY), no_persist(),
                                OffPolicyTrainingConfig(max_epochs=1, epoch_num_steps=300, buffer_size=2000,
                                                        num_train_envs=2, num_test_envs=2, start_timesteps=100,
                                                        test_step_num_episodes=2))
         .with_dqn_params(eps_training=0.3).build().run("host_dqn", device=CPU))
    assert r.env_step >= 400 and r.gradient_step > 0
    r = E.PPOExperimentBuilder(GymEnvFactory("CartPole-v1"), no_persist(),
                               small_onp(num_train_envs=2, num_test_envs=2)).build().run("host_ppo", device=CPU)
    assert r.env_step >= 256
    obs_space, act_space = GymEnvFactory("Pendulum-v1").spaces()
    assert obs_space.shape == (3,) and act_space.shape == (1,) and act_space.high == (2.0,)


def test_marl_builder_selfplay_smoke():
    r = (E.MARLExperimentBuilder(TicTacToeEnv, n_agents=2, config=no_persist(),
                                 training=OffPolicyTrainingConfig(
                                     max_epochs=2, epoch_num_steps=600, buffer_size=8000, num_train_envs=4,
                                     num_test_envs=4, test_step_num_episodes=4, batch_size=64,
                                     collection_step_num_env_steps=16, update_step_num_gradient_steps_per_sample=0.25,
                                     start_timesteps=128))
         .build().run("marl_ttt", device=CPU))
    assert r.env_step >= 128 + 2 * 600 and r.gradient_step > 0
    assert set(r.last_chunk_stats.keys()) == {"agent0", "agent1"} and r.last_chunk_stats.agent0.loss.shape == (16,)
    assert int(r.train_state["agent0"].step) == int(r.train_state["agent1"].step) == r.gradient_step


def test_persistence_from_directory_and_restore(tmp_path):
    cfg = ExperimentConfig(seed=0, persistence_enabled=True, persistence_base_dir=str(tmp_path))
    exp = E.DQNExperimentBuilder(CartPole, cfg, small_offp()).with_dqn_params(eps_training=0.3).build()
    r = exp.run("run1", device=CPU)
    run1 = tmp_path / "run1"
    assert (run1 / "experiment.pkl").is_file() and (run1 / "best").is_dir()
    exp2 = E.Experiment.from_directory(str(run1))
    assert isinstance(exp2, E.Experiment) and exp2.config == exp.config
    r2 = exp2.run("run2", device=CPU)
    assert r2.env_step == r.env_step and (tmp_path / "run2" / "best").is_dir()
    saved = torch.load(tmp_path / "run2" / "best" / "train_state.pt", weights_only=False)
    restored = restore_train_state(str(tmp_path / "run2" / "best"), exp2.algo_factory(CartPole()).init(CPU))
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert int(restored.step) == int(saved["step"]) > 0


def test_save_pickles_a_lambda_factory(tmp_path):
    exp = E.DQNExperimentBuilder(lambda: CartPole(), no_persist(), small_offp()).with_dqn_params(eps_training=0.3).build()
    exp.save(str(tmp_path / "lam"))
    exp2 = E.Experiment.from_directory(str(tmp_path / "lam"))
    assert isinstance(exp2, E.Experiment) and exp2.config == exp.config
    assert type(exp2.env_factory()) is CartPole


def test_watch_replays_the_trained_policy(capsys):
    cfg = ExperimentConfig(seed=0, persistence_enabled=False, watch=True, watch_num_episodes=2)
    r = E.DQNExperimentBuilder(CartPole, cfg, small_offp()).with_dqn_params(eps_training=0.3).build().run(
        "watch", device=CPU)
    assert r.env_step > 0 and "watch: mean return" in capsys.readouterr().out


def test_same_seed_same_run():
    runs = []
    for _ in range(2):
        r = E.DQNExperimentBuilder(CartPole, no_persist(), small_offp()).with_dqn_params(eps_training=0.3).build().run(
            "det", device=CPU)
        runs.append((r.best_reward, r.env_step, trace_param_hash(r.train_state)))
    assert runs[0] == runs[1]
    other = ExperimentConfig(seed=1, persistence_enabled=False)
    r = E.DQNExperimentBuilder(CartPole, other, small_offp()).with_dqn_params(eps_training=0.3).build().run(
        "det", device=CPU)
    assert trace_param_hash(r.train_state) != runs[0][2]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    exp = E.DQNExperimentBuilder(CartPole, no_persist(), small_offp()).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run("x")


@pytest.mark.slow
def test_dqn_builder_trains_to_threshold(tmp_path):
    """``tests/test_highlevel.py:34``: 195 on CartPole, persistence on."""
    r = (E.DQNExperimentBuilder(CartPole, ExperimentConfig(seed=0, persistence_base_dir=str(tmp_path)),
                                OffPolicyTrainingConfig(max_epochs=12, epoch_num_steps=5000, buffer_size=20000,
                                                        num_train_envs=10, num_test_envs=10, start_timesteps=1000,
                                                        stop_threshold=195))
         .with_dqn_params(gamma=0.97, n_step_return_horizon=3, target_update_freq=320, eps_training=0.3)
         .build().run("dqn_cartpole", device=CPU))
    assert r.best_reward >= 195
    assert (tmp_path / "dqn_cartpole" / "experiment.pkl").is_file() and (tmp_path / "dqn_cartpole" / "best").is_dir()


@pytest.mark.slow
def test_ppo_builder_trains_to_threshold():
    """``tests/test_highlevel.py:58``."""
    r = (E.PPOExperimentBuilder(CartPole, ExperimentConfig(seed=0, persistence_enabled=False),
                                OnPolicyTrainingConfig(max_epochs=10, epoch_num_steps=10000, num_train_envs=16,
                                                       stop_threshold=195))
         .build().run("ppo_cartpole", device=CPU))
    assert r.best_reward >= 195
