"""PPO on the device CartPole through the high-level Experiment API, the port
of ``examples/discrete/ppo_cartpole_hl.py`` (analogue of the reference's
examples/*_hl.py scripts), with watch mode.

    python examples_torch/discrete/ppo_cartpole_hl.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.common import add_device_arg
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OnPolicyTrainingConfig
from tianshou_tpu_torch.highlevel.experiment import PPOExperimentBuilder


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def builder():
    return PPOExperimentBuilder(
        CartPole,
        ExperimentConfig(seed=0, watch=True),
        OnPolicyTrainingConfig(
            max_epochs=10, epoch_num_steps=10000,
            num_train_envs=16, num_test_envs=10,
            stop_threshold=195,
        ),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    result = builder().build().run("ppo_cartpole", device=args.device)
    print(f"best_reward={result.best_reward:.1f}", flush=True)
    return result


if __name__ == "__main__":
    main()
