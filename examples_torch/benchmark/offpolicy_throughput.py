"""Off-policy throughput: DQN collect + update env-steps/s, the fused megastep (one program per chunk) against
separate collect and update programs, the port of ``examples/benchmark/offpolicy_throughput.py``.

DQN on the device CartPole at E = 1,024, T = 32, batch 1,024, 0.01 updates per env step, through
``OffPolicyTrainer`` for ``fused_megastep`` False and then True: a warm-up run of ``WARMUP_CHUNKS`` chunks (the
programs' eager warm-up and capture), then a timed run of ``TIMED_CHUNKS`` chunks that replays them.

    python examples_torch/benchmark/offpolicy_throughput.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import time

import torch

from examples_torch.common import add_device_arg, setup, transition_example

E, T = 1024, 32
WARMUP_CHUNKS, TIMED_CHUNKS = 2, 40


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.mlp import Net

    return DQN(
        model=Net(hidden_sizes=(128, 128), output_dim=2, input_dim=4),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.97, n_step_return_horizon=3, target_update_freq=500, eps_training=0.1,
    )


def make_params(fused: bool):
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainerParams

    return OffPolicyTrainerParams(
        max_epochs=1, epoch_num_steps=T * E * TIMED_CHUNKS, test_step_num_episodes=1,
        batch_size=1024, collection_step_num_env_steps=T, update_per_step=0.01,
        fused_megastep=fused, verbose=False,
    )


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def main(argv=None) -> dict[bool, dict]:
    """Each mode's timed run: ``{fused: {"env_steps_per_s", "env_steps", "gradient_steps", "seconds"}}``. The rate
    counts the timed run's own env steps (the JAX script divides the trainer's running count, the warm-up run's
    steps included, by the timed run's time)."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer

    args = build_parser().parse_args(argv)
    dev, gen = setup(args.device, 0)
    env = CartPole()
    algo = make_algo(env)
    buffer = VectorReplayBuffer(total_size=E * 256, buffer_num=E)
    out = {}
    for fused in (False, True):
        ts = algo.init(dev)
        buf_state = buffer.init(transition_example(torch.zeros(4), torch.tensor(0)), device=dev)
        coll = DeviceCollector(VectorDeviceEnv(env, E, device=dev), algo, buffer)
        trainer = OffPolicyTrainer(algo, coll, DeviceCollector(VectorDeviceEnv(env, 8, device=dev), algo, None),
                                   buffer, make_params(fused))
        # the warm-up run makes the programs (eager warm-up, capture), then the timed run replays them
        trainer.params.epoch_num_steps = T * E * WARMUP_CHUNKS
        res = trainer.run(ts, buf_state, gen)
        ts, buf_state = res.train_state, res.buf_state
        trainer.params.epoch_num_steps = T * E * TIMED_CHUNKS
        trainer.start_epoch = 0
        steps0, grads0 = res.env_step, res.gradient_step
        t0 = time.perf_counter()
        res = trainer.run(ts, buf_state, gen)
        dt = time.perf_counter() - t0
        steps, grads = res.env_step - steps0, res.gradient_step - grads0
        out[fused] = {"env_steps_per_s": steps / dt, "env_steps": steps, "gradient_steps": grads, "seconds": dt}
        print(f"fused={fused}: {steps / dt / 1e6:7.2f}M env-steps/s steady-state "
              f"({grads} grad steps, batch 1024)", flush=True)
    return out


if __name__ == "__main__":
    main()
