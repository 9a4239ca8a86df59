"""Typed batch protocols and runtime key contracts (port of
``tianshou_tpu/data/types.py``; reference tianshou/data/types.py:14-135).

The reference defines 15 structural ``BatchProtocol`` subclasses that
document the keys each stage of the pipeline produces and consumes. The
carrier here is always :class:`~tianshou_tpu_torch.data.batch.Batch`, so
the protocols are ``typing.Protocol`` classes over it for static annotation,
and ``validate_keys`` checks the reserved keys at run time (reference
buffer_base.py:41).
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from tianshou_tpu_torch.data.batch import Batch

Arr = torch.Tensor

__all__ = [
    "ObsBatchProtocol",
    "RolloutBatchProtocol",
    "BatchWithReturnsProtocol",
    "PrioBatchProtocol",
    "RecurrentStateBatch",
    "ActBatchProtocol",
    "ActStateBatchProtocol",
    "ModelOutputBatchProtocol",
    "FQFBatchProtocol",
    "BatchWithAdvantagesProtocol",
    "DistBatchProtocol",
    "DistLogProbBatchProtocol",
    "LogpOldProtocol",
    "QuantileRegressionBatchProtocol",
    "ImitationBatchProtocol",
    "ROLLOUT_KEYS",
    "RETURNS_KEYS",
    "ADVANTAGE_KEYS",
    "PRIO_KEYS",
    "LOGP_OLD_KEYS",
    "TRANSITION_EXAMPLE_KEYS",
    "validate_keys",
]


@runtime_checkable
class ObsBatchProtocol(Protocol):
    """Observations a policy can turn into actions (reference types.py:14)."""

    obs: Arr | Batch


class RolloutBatchProtocol(ObsBatchProtocol, Protocol):
    """One stored transition, or the outcome of sampling a buffer (:27)."""

    obs_next: Arr | Batch
    act: Arr
    rew: Arr
    terminated: Arr
    truncated: Arr


class BatchWithReturnsProtocol(RolloutBatchProtocol, Protocol):
    """A rollout with bootstrapped or Monte Carlo returns (:39)."""

    returns: Arr


class PrioBatchProtocol(RolloutBatchProtocol, Protocol):
    """A rollout with prioritized replay's importance weights (:45)."""

    weight: Arr


class RecurrentStateBatch(Protocol):
    """A recurrent carry: hidden and cell state (:52)."""

    hidden: Arr
    cell: Arr


class ActBatchProtocol(Protocol):
    """Just an action (:59), as a random policy returns it."""

    act: Arr


class ActStateBatchProtocol(ActBatchProtocol, Protocol):
    """An action and the recurrent carry, possibly None (:65)."""

    state: Any


class ModelOutputBatchProtocol(ActStateBatchProtocol, Protocol):
    """An action, the state and the model's raw logits (:73)."""

    logits: Arr


class FQFBatchProtocol(ModelOutputBatchProtocol, Protocol):
    """FQF's outputs: the fractions and the quantile values at them (:79)."""

    fractions: Arr
    quantiles_tau: Arr


class BatchWithAdvantagesProtocol(BatchWithReturnsProtocol, Protocol):
    """Returns with GAE advantages and value estimates (:86)."""

    adv: Arr
    v_s: Arr


class DistBatchProtocol(ModelOutputBatchProtocol, Protocol):
    """The parameters of the distribution of the taken actions (:96): the
    distribution classes of :mod:`tianshou_tpu_torch.models.distributions`
    are built from them."""

    dist_params: Arr | Batch


class DistLogProbBatchProtocol(DistBatchProtocol, Protocol):
    """Distribution parameters and the taken action's log-probability (:105)."""

    log_prob: Arr


class LogpOldProtocol(BatchWithAdvantagesProtocol, Protocol):
    """Advantages with the behaviour policy's log-probabilities, PPO's ratios (:111)."""

    logp_old: Arr


class QuantileRegressionBatchProtocol(ModelOutputBatchProtocol, Protocol):
    """The sampled fractions of IQN- and QRDQN-style quantile regression (:120)."""

    taus: Arr


class ImitationBatchProtocol(ModelOutputBatchProtocol, Protocol):
    """Imitation heads: Q values and imitation logits (:129)."""

    q_value: Arr
    imitation_logits: Arr


# runtime key contracts (reserved keys: reference buffer_base.py:41)
ROLLOUT_KEYS = ("obs", "act", "rew", "terminated", "truncated", "done", "obs_next")
RETURNS_KEYS = ROLLOUT_KEYS + ("returns",)
ADVANTAGE_KEYS = RETURNS_KEYS + ("adv", "v_s")
PRIO_KEYS = ROLLOUT_KEYS + ("weight",)
LOGP_OLD_KEYS = ADVANTAGE_KEYS + ("logp_old",)

# keys a transition example must provide to allocate buffer storage
# ("done" and "obs_next" are derived/optional at init time)
TRANSITION_EXAMPLE_KEYS = ("obs", "act", "rew", "terminated", "truncated")


def validate_keys(batch: Batch, required: tuple[str, ...]) -> None:
    """Raise KeyError if ``batch`` lacks any of ``required`` top-level keys."""
    missing = [k for k in required if k not in batch]
    if missing:
        raise KeyError(f"batch is missing required keys {missing}; has {list(batch.keys())}")
