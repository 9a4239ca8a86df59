"""DQN self-play on TicTacToe through the multi-agent dispatcher and the host
path, the port of ``examples/marl/tictactoe_selfplay.py`` (analogue of the
reference's test/pettingzoo/tic_tac_toe.py).

    python examples_torch/marl/tictactoe_selfplay.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

import torch
from torch import nn

from examples_torch.common import add_device_arg, setup
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.multiagent.marl import MARLRandomPolicy, MultiAgentOffPolicyAlgorithm
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.host_collector import HostCollector
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.env.tictactoe import TicTacToeEnv
from tianshou_tpu_torch.env.venvs import DummyVectorEnv
from tianshou_tpu_torch.models.mlp import MLP


class BoardQNet(nn.Module):
    """Q values of the 9 cells from the flattened ``[3, 3, 2]`` board (the dispatcher masks illegal moves)."""

    def __init__(self) -> None:
        super().__init__()
        self.mlp = MLP(18, (128, 128), 9)

    def forward(self, obs):
        return self.mlp(obs.obs.reshape(obs.obs.shape[0], -1))


def make_dqn():
    return DQN(model=BoardQNet(), action_space=Discrete(9),
               optim=AdamOptimizerFactory(lr=1e-3), gamma=0.9,
               target_update_freq=200, eps_training=0.2)


def selfplay(make_env, device, generator, prefill: int = 500, rounds: int = 200, eval_episodes: int = 100):
    """The self-play run on 8 envs of ``make_env``: a ``prefill``-step prefill, then ``rounds`` rounds of 64
    steps and one update of batch 64; then trained agent 0 against the mask-aware random policy over
    ``eval_episodes`` episodes (the JAX script's 500, 200 and 100 by default).
    Returns (the collect stats of the evaluation, the train states)."""
    obs0 = Batch(agent_id=torch.tensor(0, dtype=torch.int32), obs=torch.zeros(3, 3, 2),
                 mask=torch.ones(9, dtype=torch.bool))
    marl = MultiAgentOffPolicyAlgorithm([make_dqn(), make_dqn()], action_space=Discrete(9))
    ts = marl.init(device)
    envs = DummyVectorEnv([make_env for _ in range(8)])
    eval_envs = DummyVectorEnv([make_env for _ in range(8)])
    try:
        buffer = VectorReplayBuffer(total_size=20000, buffer_num=8)
        coll = HostCollector(envs, marl, buffer, device=device)
        coll.reset(seed=0)
        coll.buf_state = buffer.init(Batch(obs=obs0, act=torch.tensor(0), rew=torch.zeros(2),
                                           terminated=torch.tensor(False), truncated=torch.tensor(False),
                                           obs_next=obs0.map(torch.clone)), device=device)
        coll.collect(ts, generator, n_step=prefill)
        for _ in range(rounds):
            coll.collect(ts, generator, n_step=64)
            marl.update(ts, buffer, coll.buf_state, generator, 64)

        # evaluate trained agent 0 against the mask-aware random baseline
        eval_marl = MultiAgentOffPolicyAlgorithm([marl.algorithms[0], MARLRandomPolicy(Discrete(9))],
                                                 action_space=Discrete(9))
        ets = {"agent0": ts["agent0"], "agent1": eval_marl.algorithms[1].init(device)}
        ec = HostCollector(eval_envs, eval_marl, None, device=device)
        ec.reset(seed=1)
        stats = ec.collect(ets, generator, n_episode=eval_episodes, training=False)
    finally:
        envs.close()
        eval_envs.close()
    print(f"win rate vs random: {(stats.returns > 0).mean():.2f}", flush=True)
    return stats, ts


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def main(argv=None):
    args = build_parser().parse_args(argv)
    return selfplay(TicTacToeEnv, *setup(args.device, 0))


if __name__ == "__main__":
    main()
