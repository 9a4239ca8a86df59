"""Declarative Experiment / ExperimentBuilder API (port of
``tianshou_tpu/highlevel/experiment.py``).

Rebuild of reference ``highlevel/experiment.py`` (``Experiment:170``,
``ExperimentBuilder:510`` + per-algorithm builders :1105-1500) and
``highlevel/algorithm.py`` (``AlgorithmFactory:110``: buffer+collector
creation :123-166, trainer assembly :207-302). Envs are the port's batched
device :class:`Env` s (``VectorDeviceEnv``), or registered Gymnasium tasks
on the host path (:class:`~tianshou_tpu_torch.highlevel.env.GymEnvFactory`).

Usage (mirrors the reference's builder chain)::

    result = (
        DQNExperimentBuilder(CartPole, ExperimentConfig(seed=0),
                             OffPolicyTrainingConfig(max_epochs=5))
        .with_model_factory(QNetFactoryDefault(hidden_sizes=(64, 64)))
        .with_dqn_params(gamma=0.97, target_update_freq=320, eps_training=0.3)
        .build()
        .run("dqn_cartpole")
    )

``Experiment.run(run_name, device=None)`` trains on the card unless a
device is given. It seeds ``torch``'s and numpy's global generators with
``config.seed`` before the algorithm's nets are made (their initial weights)
and draws the run's randomness from a ``torch.Generator`` on the device
seeded the same. ``Experiment.save`` pickles the experiment with
``cloudpickle``, imported when it is called.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import types
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env.core import Discrete, Env, VectorDeviceEnv
from tianshou_tpu_torch.highlevel.config import (
    ExperimentConfig,
    OffPolicyTrainingConfig,
    OnPolicyTrainingConfig,
)
from tianshou_tpu_torch.highlevel.module import (
    ActorFactoryDefault,
    CriticFactoryDefault,
    QNetFactoryDefault,
    flat_dim,
)
from tianshou_tpu_torch.trainer.trainer import (
    OffPolicyTrainer,
    OffPolicyTrainerParams,
    OnPolicyTrainer,
    OnPolicyTrainerParams,
    TrainResult,
)
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.logger.base import LazyLogger
from tianshou_tpu_torch.utils.persistence import save_train_state

__all__ = [
    "Experiment",
    "ExperimentBuilder",
    "DQNExperimentBuilder",
    "PPOExperimentBuilder",
    "A2CExperimentBuilder",
    "ReinforceExperimentBuilder",
    "SACExperimentBuilder",
    "TD3ExperimentBuilder",
    "DDPGExperimentBuilder",
    "REDQExperimentBuilder",
    "NPGExperimentBuilder",
    "TRPOExperimentBuilder",
    "C51ExperimentBuilder",
    "IQNExperimentBuilder",
    "DiscreteSACExperimentBuilder",
    "CQLExperimentBuilder",
    "TD3BCExperimentBuilder",
    "BCQExperimentBuilder",
]


def _example(space) -> torch.Tensor:
    """A zero sample of ``space`` (its dtype: int64 for discrete actions)."""
    return torch.zeros(space.shape, dtype=getattr(space, "dtype", torch.float32))


def _transition_example(obs_space, act_space) -> Batch:
    return Batch(obs=_example(obs_space), act=_example(act_space), rew=torch.tensor(0.0),
                 terminated=torch.tensor(False), truncated=torch.tensor(False), obs_next=_example(obs_space))


def _seed(seed: int, device: torch.device) -> torch.Generator:
    """Seed the global generators (the nets' initial weights, numpy) and
    return the run's generator on ``device``."""
    torch.manual_seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass
class Experiment:
    """A fully-specified, runnable experiment (reference experiment.py:170)."""

    config: ExperimentConfig
    training: Any
    env_factory: Callable[[], Env]
    algo_factory: Callable[[Env], Any]
    logger_factory: Callable[[str], Any] | None = None
    offline_dataset: Any = None  # (buffer, buf_state) for offline builders
    buffer_factory: Callable[[int], Any] | None = None  # PER/HER hook
    callbacks: Any = None  # TrainerCallbacks (highlevel/trainer.py)

    def _callback_fns(self, algo, env, logger):
        """Resolve TrainerCallbacks into (train_fn, test_fn, stop_fn)
        trainer hooks (reference highlevel/algorithm.py trainer assembly)."""
        cb = self.callbacks
        if cb is None:
            return None, None, None
        from tianshou_tpu_torch.highlevel.trainer import TrainingContext

        ctx = TrainingContext(algo, env, logger)
        train_fn = cb.epoch_train_callback.get_trainer_fn(ctx) if cb.epoch_train_callback else None
        test_fn = cb.epoch_test_callback.get_trainer_fn(ctx) if cb.epoch_test_callback else None
        stop_fn = cb.epoch_stop_callback.get_trainer_fn(ctx) if cb.epoch_stop_callback else None
        return train_fn, test_fn, stop_fn

    def _stop_fn(self, cb_stop_fn):
        tc = self.training
        if cb_stop_fn is None and tc.stop_threshold is not None:
            return lambda r: r >= tc.stop_threshold
        return cb_stop_fn

    def run(self, run_name: str = "experiment", device: str | torch.device | None = None) -> TrainResult:
        """Build and train on ``device`` (default: the card)."""
        from tianshou_tpu_torch.highlevel.env import GymEnvFactory

        dev = resolve_device(device)
        if isinstance(self.env_factory, GymEnvFactory):
            return self._run_host(run_name, dev)
        cfg, tc = self.config, self.training
        gen = _seed(cfg.seed, dev)
        env = self.env_factory()
        algo = self.algo_factory(env)
        ts = algo.init(dev)

        train_envs = VectorDeviceEnv(env, tc.num_train_envs, device=dev)
        test_envs = VectorDeviceEnv(env, tc.num_test_envs, device=dev)
        logger = self.logger_factory(run_name) if self.logger_factory else LazyLogger()

        persist_dir = os.path.join(cfg.persistence_base_dir, run_name)
        save_best = None
        if cfg.persistence_enabled:
            os.makedirs(persist_dir, exist_ok=True)

            def save_best(best_ts):
                save_train_state(os.path.join(persist_dir, "best"), best_ts)

        cb_train_fn, cb_test_fn, cb_stop_fn = self._callback_fns(algo, env, logger)
        stop_fn = self._stop_fn(cb_stop_fn)

        if self.offline_dataset is not None:
            from tianshou_tpu_torch.trainer.trainer import OfflineTrainer, OfflineTrainerParams

            buffer, buf_state = self.offline_dataset
            ecol = DeviceCollector(test_envs, algo, None)
            params = OfflineTrainerParams(
                max_epochs=tc.max_epochs,
                update_step_num_gradient_steps_per_epoch=getattr(tc, "update_step_num_gradient_steps_per_epoch", 500),
                batch_size=getattr(tc, "batch_size", 128),
                test_step_num_episodes=tc.test_step_num_episodes,
                stop_fn=stop_fn,
                train_fn=cb_train_fn,
                test_fn=cb_test_fn,
                save_best_fn=save_best,
                logger=logger,
                verbose=False,
            )
            result = OfflineTrainer(algo, buffer, ecol, params).run(ts, buf_state, gen)
        elif isinstance(tc, OnPolicyTrainingConfig):
            tcol = DeviceCollector(train_envs, algo, None)
            ecol = DeviceCollector(test_envs, algo, None)
            params = OnPolicyTrainerParams(
                max_epochs=tc.max_epochs,
                epoch_num_steps=tc.epoch_num_steps,
                test_step_num_episodes=tc.test_step_num_episodes,
                batch_size=tc.batch_size,
                collection_step_num_env_steps=tc.collection_step_num_env_steps,
                update_step_num_repetitions=tc.update_step_num_repetitions,
                stop_fn=stop_fn,
                train_fn=cb_train_fn,
                test_fn=cb_test_fn,
                save_best_fn=save_best,
                logger=logger,
                verbose=False,
            )
            result = OnPolicyTrainer(algo, tcol, ecol, params).run(ts, gen)
        else:
            if self.buffer_factory is not None:
                buffer = self.buffer_factory(tc.num_train_envs)
            else:
                buffer = VectorReplayBuffer(
                    total_size=tc.buffer_size,
                    buffer_num=tc.num_train_envs,
                    stack_num=tc.replay_buffer_stack_num,
                )
            buf_state = buffer.init(_transition_example(env.observation_space, env.action_space), device=dev)
            tcol = DeviceCollector(train_envs, algo, buffer)
            ecol = DeviceCollector(test_envs, algo, None)
            params = OffPolicyTrainerParams(
                max_epochs=tc.max_epochs,
                epoch_num_steps=tc.epoch_num_steps,
                test_step_num_episodes=tc.test_step_num_episodes,
                batch_size=tc.batch_size,
                collection_step_num_env_steps=tc.collection_step_num_env_steps,
                update_per_step=tc.update_step_num_gradient_steps_per_sample,
                start_steps=tc.start_timesteps,
                start_random=tc.start_timesteps_random,
                stop_fn=stop_fn,
                train_fn=cb_train_fn,
                test_fn=cb_test_fn,
                save_best_fn=save_best,
                logger=logger,
                verbose=False,
            )
            result = OffPolicyTrainer(algo, tcol, ecol, buffer, params).run(ts, buf_state, gen)

        if cfg.persistence_enabled:
            self.save(persist_dir)
        if cfg.watch:
            stats = DeviceCollector(test_envs, algo, None).collect_episodes(result.train_state, gen,
                                                                            cfg.watch_num_episodes, training=False)
            print(f"watch: mean return {stats.returns.mean():.2f} over {len(stats.returns)} episodes")
        return result

    def _run_host(self, run_name: str, dev: torch.device) -> TrainResult:
        """Host path for registered Gymnasium tasks: host collectors, the
        update on ``dev``, and the host trainers (off- and on-policy)."""
        from tianshou_tpu_torch.data.host_collector import HostCollector
        from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer

        cfg, tc = self.config, self.training
        gen = _seed(cfg.seed, dev)
        obs_space, act_space = self.env_factory.spaces()
        env_like = types.SimpleNamespace(observation_space=obs_space, action_space=act_space)
        algo = self.algo_factory(env_like)
        ts = algo.init(dev)
        logger = self.logger_factory(run_name) if self.logger_factory else LazyLogger()

        if isinstance(tc, OnPolicyTrainingConfig):
            from tianshou_tpu_torch.trainer.trainer import HostOnPolicyTrainer

            tcol = HostCollector(self.env_factory.create_venv(tc.num_train_envs), algo, device=dev)
            ecol = HostCollector(self.env_factory.create_venv(tc.num_test_envs), algo, device=dev)
            cb_train_fn, cb_test_fn, cb_stop_fn = self._callback_fns(algo, env_like, logger)
            params = OnPolicyTrainerParams(
                train_fn=cb_train_fn,
                test_fn=cb_test_fn,
                max_epochs=tc.max_epochs,
                epoch_num_steps=tc.epoch_num_steps,
                test_step_num_episodes=tc.test_step_num_episodes,
                batch_size=tc.batch_size,
                collection_step_num_env_steps=tc.collection_step_num_env_steps,
                update_step_num_repetitions=tc.update_step_num_repetitions,
                stop_fn=self._stop_fn(cb_stop_fn),
                logger=logger,
                verbose=False,
                seed=cfg.seed,
            )
            result = HostOnPolicyTrainer(algo, tcol, ecol, params).run(ts, gen)
            self._watch_host(algo, result, gen, dev)
            return result

        buffer = VectorReplayBuffer(total_size=tc.buffer_size, buffer_num=tc.num_train_envs,
                                    stack_num=tc.replay_buffer_stack_num)
        buf_state = buffer.init(_transition_example(obs_space, act_space), device=dev)
        tcol = HostCollector(self.env_factory.create_venv(tc.num_train_envs), algo, buffer, device=dev)
        ecol = HostCollector(self.env_factory.create_venv(tc.num_test_envs), algo, None, device=dev)
        cb_train_fn, cb_test_fn, cb_stop_fn = self._callback_fns(algo, env_like, logger)
        params = OffPolicyTrainerParams(
            train_fn=cb_train_fn,
            test_fn=cb_test_fn,
            max_epochs=tc.max_epochs,
            epoch_num_steps=tc.epoch_num_steps,
            test_step_num_episodes=tc.test_step_num_episodes,
            batch_size=tc.batch_size,
            collection_step_num_env_steps=tc.collection_step_num_env_steps,
            update_per_step=tc.update_step_num_gradient_steps_per_sample,
            start_steps=tc.start_timesteps,
            start_random=tc.start_timesteps_random,
            stop_fn=self._stop_fn(cb_stop_fn),
            logger=logger,
            verbose=False,
            seed=cfg.seed,
        )
        result = HostOffPolicyTrainer(algo, tcol, ecol, buffer, params).run(ts, buf_state, gen)
        self._watch_host(algo, result, gen, dev)
        return result

    def _watch_host(self, algo, result, gen: torch.Generator, dev: torch.device) -> None:
        """Render the trained agent on one host env (reference
        experiment.py:473 watch loop)."""
        if not self.config.watch:
            return
        from tianshou_tpu_torch.data.host_collector import HostCollector

        venv = self.env_factory.create_venv(1, render_mode="human")
        stats = HostCollector(venv, algo, device=dev).collect(
            result.train_state, gen, n_episode=self.config.watch_num_episodes, training=False,
            reset_before_collect=True)
        print(f"watch: mean return {stats.returns.mean():.2f} over {len(stats.returns)} episodes")
        venv.close()

    def save(self, path: str) -> None:
        """Persist the whole experiment definition as ``experiment.pkl`` in
        ``path`` (reference experiment.py:207-219); ``cloudpickle`` handles
        env factories, builder closures and lambdas."""
        import cloudpickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "experiment.pkl"), "wb") as f:
            cloudpickle.dump(self, f)

    @staticmethod
    def from_directory(path: str) -> "Experiment":
        """Rebuild a RUNNABLE experiment from a persisted directory
        (reference Experiment.from_directory experiment.py:243-249):
        ``from_directory(p).run(...)`` re-runs the same configuration."""
        with open(os.path.join(path, "experiment.pkl"), "rb") as f:
            exp = pickle.load(f)
        assert isinstance(exp, Experiment)
        return exp


class ExperimentBuilder:
    """Fluent builder base (reference experiment.py:510)."""

    def __init__(self, env_factory: Callable[[], Env], config: ExperimentConfig | None = None, training=None) -> None:
        self._env_factory = env_factory
        self._config = config or ExperimentConfig()
        self._training = training
        self._logger_factory: Callable | None = None
        self._optim_factory = AdamOptimizerFactory
        self._params: dict = {}

    def with_logger_factory(self, factory) -> "ExperimentBuilder":
        self._logger_factory = factory
        return self

    def with_optim_factory(self, factory) -> "ExperimentBuilder":
        self._optim_factory = factory
        return self

    def _set_params(self, params=None, **kwargs):
        """Accept a typed Params dataclass (reference algorithm_params.py)
        or plain kwargs."""
        from tianshou_tpu_torch.highlevel.params import Params

        if params is not None:
            assert isinstance(params, Params), params
            self._params = params
        else:
            self._params.update(kwargs)
        return self

    def _resolve(self, env: Env) -> dict:
        """Resolve user params into low-level constructor kwargs, running
        the ParamTransformer chain for typed Params (reference
        algorithm_params.py:19-830)."""
        from tianshou_tpu_torch.highlevel.params import Params, ParamTransformerData

        if isinstance(self._params, Params):
            return self._params.create_kwargs(
                ParamTransformerData(env=env, optim_factory_default=self._optim_factory, training=self._training)
            )
        return dict(self._params)

    def _make_algo(self, env: Env):
        raise NotImplementedError

    def with_icm(self, feature_dim: int = 32, hidden_sizes=(64,), lr_scale: float = 1.0,
                 reward_scale: float = 0.01, forward_loss_weight: float = 0.2) -> "ExperimentBuilder":
        """Wrap the built algorithm in an ICM intrinsic-curiosity wrapper
        (reference modelbased/icm.py ICMOff/OnPolicyWrapper)."""
        self._icm = dict(feature_dim=feature_dim, hidden_sizes=tuple(hidden_sizes), lr_scale=lr_scale,
                         reward_scale=reward_scale, forward_loss_weight=forward_loss_weight)
        return self

    def _maybe_wrap_icm(self, algo, env: Env, on_policy: bool):
        icm = getattr(self, "_icm", None)
        if icm is None:
            return algo
        from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOffPolicyWrapper, ICMOnPolicyWrapper
        from tianshou_tpu_torch.models.discrete import IntrinsicCuriosityModule

        n_actions = env.action_space.n if isinstance(env.action_space, Discrete) else flat_dim(env.action_space)
        model = IntrinsicCuriosityModule(feature_hidden=(icm["feature_dim"],), hidden_sizes=icm["hidden_sizes"],
                                         action_dim=n_actions, input_dim=flat_dim(env.observation_space))
        wrapper = ICMOnPolicyWrapper if on_policy else ICMOffPolicyWrapper
        return wrapper(algo, model, lr_scale=icm["lr_scale"], reward_scale=icm["reward_scale"],
                       forward_loss_weight=icm["forward_loss_weight"])

    def _get_callbacks(self):
        from tianshou_tpu_torch.highlevel.trainer import TrainerCallbacks

        if not hasattr(self, "_callbacks"):
            self._callbacks = TrainerCallbacks()
        return self._callbacks

    def with_epoch_train_callback(self, cb) -> "ExperimentBuilder":
        """Epoch-start hparam override hook (reference experiment.py:636)."""
        self._get_callbacks().epoch_train_callback = cb
        return self

    def with_epoch_test_callback(self, cb) -> "ExperimentBuilder":
        """Test-phase hparam override hook (reference experiment.py:645)."""
        self._get_callbacks().epoch_test_callback = cb
        return self

    def with_epoch_stop_callback(self, cb) -> "ExperimentBuilder":
        """Early-stop decision hook (reference experiment.py:654)."""
        self._get_callbacks().epoch_stop_callback = cb
        return self

    def with_buffer_factory(self, factory) -> "ExperimentBuilder":
        """Custom replay buffer: ``factory(num_envs) -> buffer``, the hook
        for PER (PrioritizedVectorReplayBuffer) and HER (HERReplayBuffer),
        mirroring the reference's replay_buffer config knobs
        (highlevel/config.py TrainingConfig)."""
        self._buffer_factory = factory
        return self

    def build(self) -> Experiment:
        return Experiment(
            config=self._config,
            training=self._training,
            env_factory=self._env_factory,
            algo_factory=self._make_algo,
            logger_factory=self._logger_factory,
            buffer_factory=getattr(self, "_buffer_factory", None),
            callbacks=getattr(self, "_callbacks", None),
        )


class DQNExperimentBuilder(ExperimentBuilder):
    def __init__(self, env_factory, config=None, training=None) -> None:
        super().__init__(env_factory, config, training or OffPolicyTrainingConfig())
        self._model_factory = QNetFactoryDefault()
        self._lr = 1e-3

    def with_model_factory(self, f) -> "DQNExperimentBuilder":
        self._model_factory = f
        return self

    def with_dqn_params(self, params=None, **kwargs) -> "DQNExperimentBuilder":
        return self._set_params(params, **kwargs)

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN

        kw = self._resolve(env)
        kw.setdefault("optim", self._optim_factory(lr=kw.pop("lr", self._lr)))
        algo = DQN(model=self._model_factory.create(env.observation_space, env.action_space),
                   action_space=env.action_space, **kw)
        return self._maybe_wrap_icm(algo, env, on_policy=False)


class _ActorCriticBuilder(ExperimentBuilder):
    def __init__(self, env_factory, config=None, training=None) -> None:
        super().__init__(env_factory, config, training or OnPolicyTrainingConfig())
        self._actor_factory = ActorFactoryDefault()
        self._critic_factory = CriticFactoryDefault()
        self._lr = 3e-4

    def with_actor_factory(self, f):
        self._actor_factory = f
        return self

    def with_critic_factory(self, f):
        self._critic_factory = f
        return self

    def with_params(self, params=None, **kwargs):
        return self._set_params(params, **kwargs)

    def _ac_kwargs(self, env: Env, default_lr: float) -> dict:
        kw = self._resolve(env)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", default_lr),
                                                    max_grad_norm=kw.pop("max_grad_norm", 0.5)))
        kw.setdefault("deterministic_eval", True)
        return kw

    def _nets(self, env: Env) -> dict:
        return dict(actor=self._actor_factory.create(env.observation_space, env.action_space),
                    critic=self._critic_factory.create(env.observation_space, env.action_space))


class PPOExperimentBuilder(_ActorCriticBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO

        algo = PPO(**self._nets(env), action_space=env.action_space, **self._ac_kwargs(env, self._lr))
        return self._maybe_wrap_icm(algo, env, on_policy=True)


class A2CExperimentBuilder(_ActorCriticBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C

        algo = A2C(**self._nets(env), action_space=env.action_space, **self._ac_kwargs(env, 7e-4))
        return self._maybe_wrap_icm(algo, env, on_policy=True)


class ReinforceExperimentBuilder(_ActorCriticBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.reinforce import Reinforce

        kw = self._ac_kwargs(env, 1e-3)
        for drop in ("gae_lambda", "vf_coef", "ent_coef", "advantage_normalization"):
            kw.pop(drop, None)
        return Reinforce(actor=self._actor_factory.create(env.observation_space, env.action_space),
                         action_space=env.action_space, **kw)


class _ContinuousOffPolicyBuilder(ExperimentBuilder):
    def __init__(self, env_factory, config=None, training=None) -> None:
        super().__init__(env_factory, config, training or OffPolicyTrainingConfig())
        self._actor_factory = ActorFactoryDefault()
        self._critic_factory = CriticFactoryDefault(use_action=True)

    def with_actor_factory(self, f):
        self._actor_factory = f
        return self

    def with_critic_factory(self, f):
        self._critic_factory = f
        return self

    def with_params(self, params=None, **kwargs):
        return self._set_params(params, **kwargs)

    def _offp_kwargs(self, env: Env, default_lr: float) -> dict:
        kw = self._resolve(env)
        kw.setdefault("policy_optim", AdamOptimizerFactory(lr=kw.pop("actor_lr", default_lr)))
        kw.setdefault("critic_optim", AdamOptimizerFactory(lr=kw.pop("critic_lr", default_lr)))
        return kw

    def _nets(self, env: Env) -> dict:
        return dict(actor=self._actor_factory.create(env.observation_space, env.action_space),
                    critic=self._critic_factory.create(env.observation_space, env.action_space))


class SACExperimentBuilder(_ContinuousOffPolicyBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.sac import SAC

        self._actor_factory.conditioned_sigma = True
        return SAC(**self._nets(env), action_space=env.action_space, **self._offp_kwargs(env, 3e-4))


class TD3ExperimentBuilder(_ContinuousOffPolicyBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3

        self._actor_factory.continuous_deterministic = True
        return TD3(**self._nets(env), action_space=env.action_space, **self._offp_kwargs(env, 3e-4))


class DDPGExperimentBuilder(_ContinuousOffPolicyBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG

        self._actor_factory.continuous_deterministic = True
        return DDPG(**self._nets(env), action_space=env.action_space, **self._offp_kwargs(env, 1e-3))


class REDQExperimentBuilder(_ContinuousOffPolicyBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
        from tianshou_tpu_torch.models.continuous import EnsembleCritic

        self._actor_factory.conditioned_sigma = True
        kw = self._offp_kwargs(env, 3e-4)
        ensemble = kw.pop("ensemble_size", 10)
        return REDQ(
            actor=self._actor_factory.create(env.observation_space, env.action_space),
            critic=EnsembleCritic(ensemble_size=ensemble, hidden_sizes=tuple(self._critic_factory.hidden_sizes),
                                  input_dim=flat_dim(env.observation_space), action_dim=flat_dim(env.action_space)),
            action_space=env.action_space,
            ensemble_size=ensemble,
            **kw,
        )


class _TrustRegionBuilder(_ActorCriticBuilder):
    def _tr_kwargs(self, env: Env) -> dict:
        kw = self._resolve(env)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        kw.pop("max_grad_norm", None)
        kw.setdefault("deterministic_eval", True)
        return kw


class NPGExperimentBuilder(_TrustRegionBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.npg import NPG

        return NPG(**self._nets(env), action_space=env.action_space, **self._tr_kwargs(env))


class TRPOExperimentBuilder(_TrustRegionBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO

        return TRPO(**self._nets(env), action_space=env.action_space, **self._tr_kwargs(env))


class C51ExperimentBuilder(DQNExperimentBuilder):
    def __init__(self, env_factory, config=None, training=None) -> None:
        super().__init__(env_factory, config, training)
        self._model_factory = QNetFactoryDefault(num_atoms=51, softmax=True)

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.c51 import C51

        kw = self._resolve(env)
        num_atoms = kw.pop("num_atoms", self._model_factory.num_atoms)
        self._model_factory.num_atoms = num_atoms
        self._model_factory.softmax = True
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        return C51(model=self._model_factory.create(env.observation_space, env.action_space),
                   action_space=env.action_space, num_atoms=num_atoms, **kw)


class IQNExperimentBuilder(DQNExperimentBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
        from tianshou_tpu_torch.models.discrete import ImplicitQuantileNetwork

        kw = self._resolve(env)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        return IQN(
            model=ImplicitQuantileNetwork(hidden_sizes=tuple(self._model_factory.hidden_sizes),
                                          action_dim=env.action_space.n, input_dim=flat_dim(env.observation_space)),
            action_space=env.action_space,
            **kw,
        )


class _OfflineBuilder(ExperimentBuilder):
    """Offline builders train from a fixed dataset (reference
    highlevel/experiment.py offline variants). Provide the dataset as a
    buffer and its state on the run's device via
    ``with_dataset(buffer, buf_state)``. Unlike the JAX builders, building
    the algorithm reads the params without popping them, so that a second
    build (``Experiment.from_directory(p).run()``) sees the same ones."""

    def __init__(self, env_factory, config=None, training=None) -> None:
        from tianshou_tpu_torch.highlevel.config import TrainingConfig

        super().__init__(env_factory, config, training or TrainingConfig())
        self._dataset = None

    def with_dataset(self, buffer, buf_state) -> "_OfflineBuilder":
        self._dataset = (buffer, buf_state)
        return self

    def with_params(self, **kwargs):
        self._params.update(kwargs)
        return self

    def build(self) -> "Experiment":
        assert self._dataset is not None, "call with_dataset(buffer, buf_state) first"
        exp = super().build()
        exp.offline_dataset = self._dataset
        return exp

    def _dims(self, env: Env) -> dict:
        return dict(input_dim=flat_dim(env.observation_space))

    def _critic(self, env: Env, hidden: tuple[int, ...]):
        from tianshou_tpu_torch.models.continuous import ContinuousCritic

        return ContinuousCritic(hidden_sizes=hidden, input_dim=flat_dim(env.observation_space),
                                action_dim=flat_dim(env.action_space))

    def _lr_kwargs(self) -> tuple[dict, float, tuple[int, ...]]:
        """(the other params, ``lr``, ``hidden_sizes``) of the discrete and BC builders."""
        kw = dict(self._params)
        return kw, kw.pop("lr", 1e-3), tuple(kw.pop("hidden_sizes", (64, 64)))


class CQLExperimentBuilder(_OfflineBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.cql import CQL
        from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic

        kw = dict(self._params)
        dim = int(env.action_space.shape[0])
        return CQL(
            actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=dim, conditioned_sigma=True,
                                               **self._dims(env)),
            critic=self._critic(env, (128, 128)),
            action_space=env.action_space,
            policy_optim=AdamOptimizerFactory(lr=kw.pop("actor_lr", 3e-4)),
            critic_optim=AdamOptimizerFactory(lr=kw.pop("critic_lr", 3e-4)),
            **kw,
        )


class TD3BCExperimentBuilder(_OfflineBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
        from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic

        kw = dict(self._params)
        dim = int(env.action_space.shape[0])
        return TD3BC(
            actor=ContinuousActorDeterministic(hidden_sizes=(128, 128), action_dim=dim, **self._dims(env)),
            critic=self._critic(env, (128, 128)),
            action_space=env.action_space,
            policy_optim=AdamOptimizerFactory(lr=kw.pop("actor_lr", 3e-4)),
            critic_optim=AdamOptimizerFactory(lr=kw.pop("critic_lr", 3e-4)),
            **kw,
        )


class BCQExperimentBuilder(_OfflineBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
        from tianshou_tpu_torch.models.continuous import VAE, Perturbation

        dim = int(env.action_space.shape[0])
        return BCQ(
            actor_perturbation=Perturbation(hidden_sizes=(64, 64), action_dim=dim, **self._dims(env)),
            critic=self._critic(env, (64, 64)),
            vae=VAE(encoder_hidden=(64,), decoder_hidden=(64,), action_dim=dim, latent_dim=2 * dim,
                    **self._dims(env)),
            action_space=env.action_space,
            **self._params,
        )


class DiscreteSACExperimentBuilder(ExperimentBuilder):
    def __init__(self, env_factory, config=None, training=None) -> None:
        super().__init__(env_factory, config, training or OffPolicyTrainingConfig())
        self._hidden = (64, 64)

    def with_params(self, params=None, **kwargs):
        return self._set_params(params, **kwargs)

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
        from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic

        kw = self._resolve(env)
        kw.setdefault("policy_optim", AdamOptimizerFactory(lr=kw.pop("actor_lr", 5e-4)))
        kw.setdefault("critic_optim", AdamOptimizerFactory(lr=kw.pop("critic_lr", 5e-4)))
        n, obs_dim = env.action_space.n, flat_dim(env.observation_space)
        return DiscreteSAC(
            actor=DiscreteActor(hidden_sizes=self._hidden, action_dim=n, input_dim=obs_dim),
            critic=DiscreteCritic(hidden_sizes=self._hidden, last_size=n, input_dim=obs_dim),
            action_space=env.action_space,
            **kw,
        )


class QRDQNExperimentBuilder(DQNExperimentBuilder):
    """Reference mixins experiment.py:1105-1500 (QRDQN)."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN

        kw = self._resolve(env)
        num_quantiles = kw.pop("num_quantiles", 200)
        self._model_factory.num_atoms = num_quantiles
        self._model_factory.softmax = False
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        kw.pop("is_double", None)
        return QRDQN(model=self._model_factory.create(env.observation_space, env.action_space),
                     action_space=env.action_space, num_quantiles=num_quantiles, **kw)


class FQFExperimentBuilder(DQNExperimentBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
        from tianshou_tpu_torch.models.discrete import FullQuantileFunction

        kw = self._resolve(env)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        kw.pop("is_double", None)
        return FQF(
            model=FullQuantileFunction(hidden_sizes=tuple(self._model_factory.hidden_sizes),
                                       action_dim=env.action_space.n, input_dim=flat_dim(env.observation_space)),
            action_space=env.action_space,
            **kw,
        )


class RainbowExperimentBuilder(DQNExperimentBuilder):
    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.c51 import RainbowDQN
        from tianshou_tpu_torch.models.discrete import RainbowNet

        kw = self._resolve(env)
        num_atoms = kw.pop("num_atoms", 51)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        kw.pop("is_double", None)
        return RainbowDQN(
            model=RainbowNet(hidden_sizes=tuple(self._model_factory.hidden_sizes), action_dim=env.action_space.n,
                             num_atoms=num_atoms, input_dim=flat_dim(env.observation_space)),
            action_space=env.action_space,
            num_atoms=num_atoms,
            **kw,
        )


class BDQNExperimentBuilder(DQNExperimentBuilder):
    """Branching dueling Q for MultiDiscrete action spaces."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
        from tianshou_tpu_torch.models.mlp import BranchingNet

        kw = self._resolve(env)
        kw.setdefault("optim", AdamOptimizerFactory(lr=kw.pop("lr", 1e-3)))
        space = env.action_space
        return BDQN(
            model=BranchingNet(hidden_sizes=tuple(self._model_factory.hidden_sizes), num_branches=space.shape[0],
                               action_per_branch=int(space.nvec[0]), input_dim=flat_dim(env.observation_space)),
            action_space=space,
            **kw,
        )


class GAILExperimentBuilder(_ActorCriticBuilder):
    """GAIL = PPO + discriminator over (obs, act) with expert data
    (reference imitation/gail.py:31)."""

    def with_expert_data(self, expert_obs, expert_act) -> "GAILExperimentBuilder":
        self._expert = (expert_obs, expert_act)
        return self

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
        from tianshou_tpu_torch.models.continuous import ContinuousCritic

        assert getattr(self, "_expert", None) is not None, "call with_expert_data first"
        return GAIL(
            **self._nets(env),
            action_space=env.action_space,
            disc_net=ContinuousCritic(hidden_sizes=(64, 64), input_dim=flat_dim(env.observation_space),
                                      action_dim=flat_dim(env.action_space)),
            expert_obs=self._expert[0],
            expert_act=self._expert[1],
            **self._ac_kwargs(env, 3e-4),
        )


class ImitationLearningExperimentBuilder(_OfflineBuilder):
    """Behavior cloning from an offline dataset (reference
    imitation/imitation_base.py ImitationLearning via OfflineTrainer)."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
        from tianshou_tpu_torch.models.continuous import ContinuousActorDeterministic
        from tianshou_tpu_torch.models.mlp import Net

        kw, lr, hidden = self._lr_kwargs()
        if isinstance(env.action_space, Discrete):
            model = Net(hidden_sizes=hidden, output_dim=env.action_space.n, **self._dims(env))
        else:
            model = ContinuousActorDeterministic(hidden_sizes=hidden, action_dim=int(env.action_space.shape[0]),
                                                 **self._dims(env))
        return ImitationLearning(model=model, action_space=env.action_space, optim=AdamOptimizerFactory(lr=lr), **kw)


class DiscreteBCQExperimentBuilder(_OfflineBuilder):
    """Discrete batch-constrained Q (reference imitation/discrete_bcq.py)."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
        from tianshou_tpu_torch.models.mlp import Net

        kw, lr, hidden = self._lr_kwargs()
        n = env.action_space.n
        return DiscreteBCQ(model=Net(hidden_sizes=hidden, output_dim=n, **self._dims(env)),
                           imitator=Net(hidden_sizes=hidden, output_dim=n, **self._dims(env)),
                           action_space=env.action_space, optim=AdamOptimizerFactory(lr=lr), **kw)


class DiscreteCQLExperimentBuilder(_OfflineBuilder):
    """Discrete conservative Q-learning over QRDQN quantiles (reference
    imitation/discrete_cql.py)."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
        from tianshou_tpu_torch.models.mlp import Net

        kw, lr, hidden = self._lr_kwargs()
        num_quantiles = kw.pop("num_quantiles", 200)
        return DiscreteCQL(
            model=Net(hidden_sizes=hidden, output_dim=env.action_space.n, num_atoms=num_quantiles, **self._dims(env)),
            action_space=env.action_space, num_quantiles=num_quantiles, optim=AdamOptimizerFactory(lr=lr), **kw)


class DiscreteCRRExperimentBuilder(_OfflineBuilder):
    """Discrete critic-regularized regression (reference
    imitation/discrete_crr.py)."""

    def _make_algo(self, env: Env):
        from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
        from tianshou_tpu_torch.models.mlp import Net

        kw, lr, hidden = self._lr_kwargs()
        n = env.action_space.n
        return DiscreteCRR(actor=Net(hidden_sizes=hidden, output_dim=n, **self._dims(env)),
                           critic=Net(hidden_sizes=hidden, output_dim=n, **self._dims(env)),
                           action_space=env.action_space, optim=AdamOptimizerFactory(lr=lr), **kw)


# ---------------------------------------------------------------------------
# multi-agent RL
# ---------------------------------------------------------------------------
def _board_dim(env) -> int:
    """The flattened width of a multi-agent env's per-agent observation (a
    PettingZoo ``Dict`` space's ``"observation"``)."""
    space = env.observation_space
    spaces = getattr(space, "spaces", None)
    if isinstance(spaces, dict) and "observation" in spaces:
        space = spaces["observation"]
    return flat_dim(space)


@dataclasses.dataclass
class MARLExperiment(Experiment):
    """Runnable multi-agent self-play experiment over a host multi-agent
    env (dict obs {agent_id, obs, mask}: env/tictactoe.py), built on
    MultiAgentOffPolicyAlgorithm + HostOffPolicyTrainer."""

    n_agents: int = 2

    def run(self, run_name: str = "marl", device: str | torch.device | None = None) -> TrainResult:
        from tianshou_tpu_torch.data.host_collector import HostCollector
        from tianshou_tpu_torch.env.venvs import DummyVectorEnv
        from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer

        cfg, tc = self.config, self.training
        dev = resolve_device(device)
        gen = _seed(cfg.seed, dev)
        env = self.env_factory()
        marl = self.algo_factory(env)
        obs0, _ = env.reset(seed=cfg.seed)
        obs_ex = Batch(
            agent_id=torch.tensor(int(obs0["agent_id"]), dtype=torch.int32),
            obs=torch.as_tensor(np.asarray(obs0["obs"], np.float32)),
            mask=torch.as_tensor(np.asarray(obs0["mask"], bool)),
        )
        ts = marl.init(dev)
        buffer = VectorReplayBuffer(total_size=tc.buffer_size, buffer_num=tc.num_train_envs)
        example = Batch(obs=obs_ex, act=torch.tensor(0), rew=torch.zeros(self.n_agents), terminated=torch.tensor(False),
                        truncated=torch.tensor(False), obs_next=obs_ex)
        buf_state = buffer.init(example, device=dev)
        tcol = HostCollector(DummyVectorEnv([self.env_factory for _ in range(tc.num_train_envs)]), marl, buffer,
                             device=dev)
        ecol = HostCollector(DummyVectorEnv([self.env_factory for _ in range(tc.num_test_envs)]), marl, None,
                             device=dev)
        logger = self.logger_factory(run_name) if self.logger_factory else LazyLogger()
        params = OffPolicyTrainerParams(
            max_epochs=tc.max_epochs,
            epoch_num_steps=tc.epoch_num_steps,
            test_step_num_episodes=tc.test_step_num_episodes,
            batch_size=tc.batch_size,
            collection_step_num_env_steps=tc.collection_step_num_env_steps,
            update_per_step=tc.update_step_num_gradient_steps_per_sample,
            start_steps=tc.start_timesteps,
            start_random=tc.start_timesteps_random,
            logger=logger, verbose=False, seed=cfg.seed,
        )
        return HostOffPolicyTrainer(marl, tcol, ecol, buffer, params).run(ts, buf_state, gen)


class MARLExperimentBuilder(ExperimentBuilder):
    """Self-play MARL builder (the reference exposes MARL through the
    low-level API + pettingzoo examples; this builder brings it to the
    declarative surface). ``env_factory() -> multi-agent host env`` with
    dict observations; per-agent algorithms come from
    ``with_agent_factory`` (default: masked DQN)."""

    def __init__(self, env_factory, n_agents: int = 2, config=None, training=None) -> None:
        super().__init__(env_factory, config, training or OffPolicyTrainingConfig())
        self._n_agents = n_agents
        self._agent_factory = None

    def with_agent_factory(self, factory) -> "MARLExperimentBuilder":
        """``factory(env, agent_index) -> OffPolicyAlgorithm``."""
        self._agent_factory = factory
        return self

    def _default_agent(self, env, _i):
        from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
        from tianshou_tpu_torch.models.discrete import MaskedQNet

        n = int(env.action_space.n)
        return DQN(
            model=MaskedQNet(hidden_sizes=(128, 128), action_dim=n, input_dim=_board_dim(env)),
            action_space=Discrete(n),
            optim=AdamOptimizerFactory(lr=1e-3),
            gamma=0.9, n_step_return_horizon=1, target_update_freq=200, eps_training=0.2,
        )

    def _make_algo(self, env):
        from tianshou_tpu_torch.algorithm.multiagent.marl import MultiAgentOffPolicyAlgorithm

        factory = self._agent_factory or self._default_agent
        agents = [factory(env, i) for i in range(self._n_agents)]
        return MultiAgentOffPolicyAlgorithm(agents, action_space=Discrete(int(env.action_space.n)))

    def build(self) -> MARLExperiment:
        return MARLExperiment(
            config=self._config,
            training=self._training,
            env_factory=self._env_factory,
            algo_factory=self._make_algo,
            logger_factory=self._logger_factory,
            n_agents=self._n_agents,
        )
