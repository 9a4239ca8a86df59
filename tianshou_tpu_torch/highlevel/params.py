"""Typed parameter dataclasses + ParamTransformer chains (port of
``tianshou_tpu/highlevel/params.py``).

Rebuild of reference ``highlevel/params/algorithm_params.py:19-830``: users
configure algorithms through per-algorithm ``Params`` dataclasses whose
user-facing fields (learning rates + scheduler factories, exploration-noise
specs, auto-alpha, n-step horizons ...) are translated into low-level
constructor kwargs by a chain of :class:`ParamTransformer` objects. The
transformers target the port's stack: optimizer fields collapse into an
optimizer factory (:mod:`tianshou_tpu_torch.algorithm.optim`), lr schedules
into :func:`~tianshou_tpu_torch.algorithm.optim.linear_lr_schedule`, noise
specs into :class:`~tianshou_tpu_torch.exploration.noise.GaussianNoise`, and
FQF's fraction rate into the port's optax-formula RMSprop.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Callable

from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, RMSpropOptimizerFactory, linear_lr_schedule

__all__ = [
    "ParamTransformerData",
    "ParamTransformer",
    "ParamTransformerDrop",
    "ParamTransformerRename",
    "ParamTransformerOptimFactory",
    "ParamTransformerNoiseFactory",
    "LRSchedulerFactoryLinear",
    "Params",
    "ReinforceParams",
    "A2CParams",
    "PPOParams",
    "NPGParams",
    "TRPOParams",
    "DQNParams",
    "C51Params",
    "RainbowParams",
    "QRDQNParams",
    "IQNParams",
    "FQFParams",
    "BDQNParams",
    "DDPGParams",
    "TD3Params",
    "SACParams",
    "DiscreteSACParams",
    "REDQParams",
]


@dataclasses.dataclass
class ParamTransformerData:
    """Context for transformations (reference ParamTransformerData:18):
    the environment (spaces), the default optimizer factory, and the
    training config (for schedulers that need the total update count)."""

    env: Any
    optim_factory_default: Callable = AdamOptimizerFactory
    training: Any = None


class ParamTransformer(ABC):
    """Transforms kwargs from the high-level to the low-level representation
    (reference ParamTransformer:31)."""

    @abstractmethod
    def transform(self, kwargs: dict[str, Any], data: ParamTransformerData) -> None: ...


class ParamTransformerDrop(ParamTransformer):
    def __init__(self, *keys: str) -> None:
        self.keys = keys

    def transform(self, kwargs: dict[str, Any], data: ParamTransformerData) -> None:
        for k in self.keys:
            kwargs.pop(k, None)


class ParamTransformerRename(ParamTransformer):
    def __init__(self, renames: dict[str, str]) -> None:
        self.renames = renames

    def transform(self, kwargs: dict[str, Any], data: ParamTransformerData) -> None:
        for old, new in self.renames.items():
            if old in kwargs:
                kwargs[new] = kwargs.pop(old)


@dataclasses.dataclass
class LRSchedulerFactoryLinear:
    """Linear decay to zero over the whole run (reference
    LRSchedulerFactoryLinear, optim.py:22). The total update count is
    derived from the training config at build time."""

    def create(self, lr: float, training: Any) -> Any:
        total = 1000
        if training is not None:
            steps_per_collect = getattr(training, "collection_step_num_env_steps", 1) * getattr(
                training, "num_train_envs", 1
            )
            collects = max(
                1, training.max_epochs * training.epoch_num_steps // max(steps_per_collect, 1)
            )
            # horizon in GRADIENT steps: the schedule advances once per
            # optimizer update, not per rollout.  On-policy: minibatches x
            # repetitions per collect; off-policy: round(update_per_step *
            # env steps collected) gradient steps per collect.
            ups = getattr(training, "update_step_num_gradient_steps_per_sample", None)
            if ups is not None:
                total = collects * max(1, round(ups * steps_per_collect))
            else:
                n_mb = max(1, steps_per_collect // max(getattr(training, "batch_size", steps_per_collect), 1))
                total = collects * max(getattr(training, "update_step_num_repetitions", 1), 1) * n_mb
        return linear_lr_schedule(lr, total)


class ParamTransformerOptimFactory(ParamTransformer):
    """Collapse (lr, lr_scheduler_factory, max_grad_norm) into one optimizer
    factory under ``key_out`` (reference ParamTransformerOptimFactory:95)."""

    def __init__(self, key_lr: str, key_out: str, key_sched: str = "lr_scheduler",
                 key_clip: str | None = None) -> None:
        self.key_lr = key_lr
        self.key_out = key_out
        self.key_sched = key_sched
        self.key_clip = key_clip

    def transform(self, kwargs: dict[str, Any], data: ParamTransformerData) -> None:
        lr = kwargs.pop(self.key_lr)
        sched = kwargs.pop(self.key_sched, None)
        clip = kwargs.pop(self.key_clip, None) if self.key_clip else None
        if sched is not None:
            lr = sched.create(lr, data.training)
        kwargs[self.key_out] = data.optim_factory_default(lr=lr, max_grad_norm=clip)


class ParamTransformerNoiseFactory(ParamTransformer):
    """float sigma -> GaussianNoise (reference ParamTransformerNoiseFactory)."""

    def __init__(self, key: str) -> None:
        self.key = key

    def transform(self, kwargs: dict[str, Any], data: ParamTransformerData) -> None:
        v = kwargs.get(self.key)
        if isinstance(v, (int, float)):
            from tianshou_tpu_torch.exploration.noise import GaussianNoise

            kwargs[self.key] = GaussianNoise(sigma=float(v))


# ---------------------------------------------------------------------------
# Params dataclasses (reference Params:170 + per-algorithm subclasses)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(kw_only=True)
class Params:
    def _get_param_transformers(self) -> list[ParamTransformer]:
        return []

    def create_kwargs(self, data: ParamTransformerData) -> dict[str, Any]:
        kwargs = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for t in self._get_param_transformers():
            t.transform(kwargs, data)
        return {k: v for k, v in kwargs.items() if v is not _UNSET}


_UNSET = object()


@dataclasses.dataclass(kw_only=True)
class ParamsMixinSingleModel:
    """lr (+ optional scheduler, grad clip) -> ``optim`` kwarg."""

    lr: float = 1e-3
    lr_scheduler: LRSchedulerFactoryLinear | None = None
    max_grad_norm: float | None = None

    def _t_single(self) -> list[ParamTransformer]:
        return [ParamTransformerOptimFactory("lr", "optim", "lr_scheduler", "max_grad_norm")]


@dataclasses.dataclass(kw_only=True)
class ParamsMixinActorAndCritic:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    actor_lr_scheduler: LRSchedulerFactoryLinear | None = None
    critic_lr_scheduler: LRSchedulerFactoryLinear | None = None

    def _t_actor_critic(self) -> list[ParamTransformer]:
        return [
            ParamTransformerOptimFactory("actor_lr", "policy_optim", "actor_lr_scheduler"),
            ParamTransformerOptimFactory("critic_lr", "critic_optim", "critic_lr_scheduler"),
        ]


# -- on-policy family -------------------------------------------------------


@dataclasses.dataclass(kw_only=True)
class ReinforceParams(Params, ParamsMixinSingleModel):
    """Reference ReinforceParams:356."""

    gamma: float = 0.99
    return_standardization: bool = False
    deterministic_eval: bool = True

    def _get_param_transformers(self):
        return self._t_single()


@dataclasses.dataclass(kw_only=True)
class A2CParams(ReinforceParams):
    """Reference A2CParams:413."""

    gae_lambda: float = 0.95
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    advantage_normalization: bool = False


@dataclasses.dataclass(kw_only=True)
class PPOParams(A2CParams):
    """Reference PPOParams:446."""

    eps_clip: float = 0.2
    dual_clip: float | None = None
    value_clip: bool = False
    advantage_normalization: bool = True


@dataclasses.dataclass(kw_only=True)
class NPGParams(Params, ParamsMixinSingleModel):
    """Reference NPGParams:506 (``actor_step_size`` -> the low-level
    ``trust_region_size``)."""

    gamma: float = 0.99
    gae_lambda: float = 0.95
    optim_critic_iters: int = 5
    actor_step_size: float = 0.5
    advantage_normalization: bool = True
    deterministic_eval: bool = True

    def _get_param_transformers(self):
        return [*self._t_single(), ParamTransformerRename({"actor_step_size": "trust_region_size"})]


@dataclasses.dataclass(kw_only=True)
class TRPOParams(NPGParams):
    """Reference TRPOParams:539."""

    max_kl: float = 0.01
    backtrack_coeff: float = 0.8
    max_backtracks: int = 10


# -- Q-learning family ------------------------------------------------------


@dataclasses.dataclass(kw_only=True)
class DQNParams(Params, ParamsMixinSingleModel):
    """Reference DQNParams / QLearningOffPolicyParams."""

    gamma: float = 0.99
    n_step_return_horizon: int = 1
    target_update_freq: int = 0
    eps_training: float = 0.0
    eps_inference: float = 0.0
    is_double: bool = True

    def _get_param_transformers(self):
        return self._t_single()


@dataclasses.dataclass(kw_only=True)
class C51Params(DQNParams):
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0

    def _get_param_transformers(self):
        # is_double is a plain-DQN knob (dqn.py:141); distributional heads drop it
        return [*super()._get_param_transformers(), ParamTransformerDrop("is_double")]


@dataclasses.dataclass(kw_only=True)
class RainbowParams(C51Params):
    pass


@dataclasses.dataclass(kw_only=True)
class QRDQNParams(DQNParams):
    num_quantiles: int = 200

    def _get_param_transformers(self):
        return [*super()._get_param_transformers(), ParamTransformerDrop("is_double")]


@dataclasses.dataclass(kw_only=True)
class IQNParams(DQNParams):
    sample_size: int = 32
    online_sample_size: int = 8
    target_sample_size: int = 8

    def _get_param_transformers(self):
        return [*super()._get_param_transformers(), ParamTransformerDrop("is_double")]


@dataclasses.dataclass(kw_only=True)
class FQFParams(DQNParams):
    num_fractions: int = 32
    ent_coef: float = 10.0
    fraction_lr: float = 2.5e-9

    def _get_param_transformers(self):
        return [
            *super()._get_param_transformers(),
            ParamTransformerDrop("is_double"),
            _FractionOptim(),
        ]


class _FractionOptim(ParamTransformer):
    """``fraction_lr`` -> ``optax.rmsprop(fraction_lr)``'s formula: decay 0.9,
    eps 1e-8 inside the square root."""

    def transform(self, kwargs, data):
        kwargs["fraction_optim"] = RMSpropOptimizerFactory(lr=kwargs.pop("fraction_lr"), alpha=0.9, eps=1e-8)


@dataclasses.dataclass(kw_only=True)
class BDQNParams(DQNParams):
    pass


# -- continuous off-policy family -------------------------------------------


@dataclasses.dataclass(kw_only=True)
class DDPGParams(Params, ParamsMixinActorAndCritic):
    """Reference DDPGParams."""

    gamma: float = 0.99
    tau: float = 0.005
    exploration_noise: Any = 0.1  # float sigma or a BaseNoise
    n_step_return_horizon: int = 1

    def _get_param_transformers(self):
        return [*self._t_actor_critic(), ParamTransformerNoiseFactory("exploration_noise")]


@dataclasses.dataclass(kw_only=True)
class TD3Params(DDPGParams):
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    update_actor_freq: int = 2


@dataclasses.dataclass(kw_only=True)
class SACParams(Params, ParamsMixinActorAndCritic):
    """Reference SACParams (auto-alpha spec included, :588 ParamsMixinAlpha)."""

    gamma: float = 0.99
    tau: float = 0.005
    alpha: float | str = 0.2  # float or "auto"
    n_step_return_horizon: int = 1
    deterministic_eval: bool = True

    def _get_param_transformers(self):
        return self._t_actor_critic()


@dataclasses.dataclass(kw_only=True)
class DiscreteSACParams(SACParams):
    pass


@dataclasses.dataclass(kw_only=True)
class REDQParams(SACParams):
    ensemble_size: int = 10
    subset_size: int = 2
    actor_delay: int = 20
