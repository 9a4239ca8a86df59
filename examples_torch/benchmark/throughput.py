"""Throughput sweep: PPO collect + update env-steps/s against the number of vectorized envs (``bench.py``'s metric
at several scales), the port of ``examples/benchmark/throughput.py``.

For each E, PPO on the device CartPole: a megastep of ``T`` collect steps (the rollout kept) and then
``update_rollout`` (``REPEAT`` passes of minibatches of ``min(BATCH, T * E)`` rows) as one program, one CUDA graph
on the card; ``WARMUP`` megasteps (the eager warm-up, then the capture), then ``ITERS`` timed.

    python examples_torch/benchmark/throughput.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import time

import torch

from examples_torch.common import add_device_arg, setup

T, REPEAT, BATCH = 128, 4, 16384
ENVS = (64, 256, 1024, 4096)
WARMUP, ITERS = 2, 10


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic

    return PPO(
        actor=DiscreteActor(hidden_sizes=(64, 64), action_dim=2, input_dim=4),
        critic=DiscreteCritic(hidden_sizes=(64, 64), input_dim=4),
        action_space=env.action_space,
        optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
    )


def env_steps_per_s(E: int, device=None) -> float:
    """The timed megasteps' env-steps/s at ``E`` envs."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.utils.graph import Graphed, GraphPool

    dev, gen = setup(device, 0)
    env = CartPole()
    algo = make_algo(env)
    coll = DeviceCollector(VectorDeviceEnv(env, E, device=dev), algo, None)
    ts = algo.init(dev)
    cstate = coll.reset(gen)
    batch = min(BATCH, T * E)

    def megastep():
        out = coll.rollout(ts, cstate, None, gen, T, keep_rollout=True)
        algo.update_rollout(ts, out.rollout, gen, REPEAT, batch)

    program = Graphed(megastep, GraphPool(dev), (gen,), name=f"ppo megastep E={E}")
    for _ in range(WARMUP):
        program()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        program()
    _sync(dev)
    return ITERS * T * E / (time.perf_counter() - t0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def main(argv=None) -> dict[int, float]:
    args = build_parser().parse_args(argv)
    rates = {}
    for E in ENVS:
        rates[E] = env_steps_per_s(E, args.device)
        print(f"E={E:5d}: {rates[E] / 1e6:8.2f}M env-steps/s", flush=True)
    return rates


if __name__ == "__main__":
    main()
