"""Algorithm namespace: every ported algorithm importable from one place
(the imitation, model-based, multi-agent and recurrent ones come with their
ports: ROADMAP.md, Queue 1)."""

from tianshou_tpu_torch.algorithm.base import Algorithm, OffPolicyAlgorithm, OnPolicyAlgorithm, TrainState
from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
from tianshou_tpu_torch.algorithm.modelfree.c51 import C51, RainbowDQN
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.fqf import FQF
from tianshou_tpu_torch.algorithm.modelfree.iqn import IQN
from tianshou_tpu_torch.algorithm.modelfree.npg import NPG
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN
from tianshou_tpu_torch.algorithm.modelfree.redq import REDQ
from tianshou_tpu_torch.algorithm.modelfree.reinforce import Reinforce
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
from tianshou_tpu_torch.algorithm.modelfree.trpo import TRPO
from tianshou_tpu_torch.algorithm.random_policy import RandomActionPolicy

__all__ = [
    "A2C", "Algorithm", "BDQN", "C51", "DDPG", "DQN", "DiscreteSAC", "FQF", "IQN", "NPG", "OffPolicyAlgorithm",
    "OnPolicyAlgorithm", "PPO", "QRDQN", "REDQ", "RainbowDQN", "RandomActionPolicy", "Reinforce", "SAC", "TD3",
    "TRPO", "TrainState",
]
