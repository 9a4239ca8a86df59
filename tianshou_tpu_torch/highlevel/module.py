"""Default actor/critic module factories (port of
``tianshou_tpu/highlevel/module.py``; reference highlevel/module/
actor.py:53-284 and critic.py:17-256): build the port's nets from env spaces.
The port's nets take their input width, so each factory reads it from the
observation space (flattened) and, for a critic over actions, the action
space."""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

from tianshou_tpu_torch.env.core import Discrete, Space
from tianshou_tpu_torch.models.continuous import (
    ContinuousActorDeterministic,
    ContinuousActorProbabilistic,
    ContinuousCritic,
)
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.models.mlp import Net

__all__ = ["ActorFactoryDefault", "CriticFactoryDefault", "QNetFactoryDefault", "flat_dim"]


def flat_dim(space: Space) -> int:
    """The flattened width of a space's samples (1 for a scalar)."""
    return math.prod(space.shape) if space.shape else 1


@dataclasses.dataclass
class ActorFactoryDefault:
    hidden_sizes: Sequence[int] = (64, 64)
    continuous_deterministic: bool = False
    conditioned_sigma: bool = False

    def create(self, obs_space: Space, act_space: Space):
        obs_dim = flat_dim(obs_space)
        if isinstance(act_space, Discrete):
            return DiscreteActor(hidden_sizes=tuple(self.hidden_sizes), action_dim=act_space.n, input_dim=obs_dim)
        dim = int(act_space.shape[0]) if act_space.shape else 1
        if self.continuous_deterministic:
            return ContinuousActorDeterministic(hidden_sizes=tuple(self.hidden_sizes), action_dim=dim, input_dim=obs_dim)
        return ContinuousActorProbabilistic(
            hidden_sizes=tuple(self.hidden_sizes), action_dim=dim, conditioned_sigma=self.conditioned_sigma,
            input_dim=obs_dim,
        )


@dataclasses.dataclass
class CriticFactoryDefault:
    hidden_sizes: Sequence[int] = (64, 64)
    use_action: bool = False

    def create(self, obs_space: Space, act_space: Space):
        if self.use_action:
            return ContinuousCritic(hidden_sizes=tuple(self.hidden_sizes), use_action=True,
                                    input_dim=flat_dim(obs_space), action_dim=flat_dim(act_space))
        return DiscreteCritic(hidden_sizes=tuple(self.hidden_sizes), input_dim=flat_dim(obs_space))


@dataclasses.dataclass
class QNetFactoryDefault:
    hidden_sizes: Sequence[int] = (64, 64)
    num_atoms: int = 1
    softmax: bool = False

    def create(self, obs_space: Space, act_space: Space):
        assert isinstance(act_space, Discrete)
        return Net(
            hidden_sizes=tuple(self.hidden_sizes),
            output_dim=act_space.n,
            num_atoms=self.num_atoms,
            softmax=self.softmax,
            input_dim=flat_dim(obs_space),
        )
