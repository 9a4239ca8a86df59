"""Algorithm namespace: every algorithm importable from one place."""

from tianshou_tpu_torch.algorithm.base import (
    Algorithm,
    OfflineAlgorithm,
    OffPolicyAlgorithm,
    OnPolicyAlgorithm,
    TrainState,
)
from tianshou_tpu_torch.algorithm.imitation.bc import ImitationLearning
from tianshou_tpu_torch.algorithm.imitation.bcq import BCQ
from tianshou_tpu_torch.algorithm.imitation.cql import CQL
from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import DiscreteBCQ
from tianshou_tpu_torch.algorithm.imitation.discrete_cql import DiscreteCQL
from tianshou_tpu_torch.algorithm.imitation.discrete_crr import DiscreteCRR
from tianshou_tpu_torch.algorithm.imitation.gail import GAIL
from tianshou_tpu_torch.algorithm.imitation.td3_bc import TD3BC
from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOffPolicyWrapper, ICMOnPolicyWrapper
from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
from tianshou_tpu_torch.algorithm.modelfree.c51 import C51, RainbowDQN
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN, RecurrentDQN
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
from tianshou_tpu_torch.algorithm.multiagent.marl import MARLRandomPolicy, MultiAgentOffPolicyAlgorithm
from tianshou_tpu_torch.algorithm.random_policy import RandomActionPolicy

__all__ = [
    "A2C", "Algorithm", "BCQ", "BDQN", "C51", "CQL", "DDPG", "DQN",
    "DiscreteBCQ", "DiscreteCQL", "DiscreteCRR", "DiscreteSAC", "FQF",
    "GAIL", "ICMOffPolicyWrapper", "ICMOnPolicyWrapper", "IQN",
    "ImitationLearning", "MARLRandomPolicy", "MultiAgentOffPolicyAlgorithm",
    "NPG", "OfflineAlgorithm", "OffPolicyAlgorithm", "OnPolicyAlgorithm",
    "PPO", "PSRL", "QRDQN", "REDQ", "RainbowDQN", "RandomActionPolicy",
    "RecurrentDQN", "Reinforce", "SAC", "TD3", "TD3BC", "TRPO", "TrainState",
]
