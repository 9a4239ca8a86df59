"""Host-path collection throughput: the sequential collector against the pipelined one, the port of
``examples/benchmark/host_throughput.py``.

The gym/Atari path keeps envs on the host (the reference's only path; its headline is ~3,000 env-step/s with
CNN+Atari, examples/atari/README.md:22). This script measures env-steps/s of ``HostCollector`` against
``PipelinedHostCollector`` over ``SubprocVectorEnv`` on an env of set cost (Gymnasium's ``CartPole-v1`` with a
sleep in its step, which needs ``gymnasium``), showing where the half-pool pipeline (the device forward overlapped
with subprocess stepping) wins.

    python examples_torch/benchmark/host_throughput.py [--env-ms 2.0] [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import time

import torch

from examples_torch.common import add_device_arg, setup, transition_example


class SleepyCartPole:
    """CartPole with an artificial per-step cost, standing in for a heavy simulator (Atari frame decode,
    physics, ...): Gymnasium's ``CartPole-v1``, or ``env`` when one is given, with ``ms`` of sleep before each
    step."""

    def __init__(self, ms: float, env=None):
        if env is None:
            import gymnasium as gym

            env = gym.make("CartPole-v1")
        self.env, self.ms = env, ms
        self.action_space = env.action_space

    def reset(self, seed=None, **kwargs):
        return self.env.reset(seed=seed, **kwargs)

    def step(self, action):
        if self.ms > 0:
            time.sleep(self.ms / 1e3)
        return self.env.step(action)

    def close(self):
        self.env.close()


def make_algo():
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env.core import Discrete
    from tianshou_tpu_torch.models.mlp import Net

    return DQN(
        model=Net(hidden_sizes=(128, 128), output_dim=2, input_dim=4),
        action_space=Discrete(2),
        optim=AdamOptimizerFactory(lr=1e-3),
        gamma=0.99, eps_training=0.1,
    )


def run(collector_cls, venv, algo, ts, n_step: int, device) -> float:
    """``n_step`` steps of ``venv`` collected by ``collector_cls`` after a warm-up of 4 vector steps: env-steps/s."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer

    buffer = VectorReplayBuffer(total_size=n_step * 2, buffer_num=len(venv))
    col = collector_cls(venv, algo, buffer, device=device)
    col.reset(seed=0)
    col.reset_buffer(transition_example(torch.zeros(4), torch.tensor(0)))
    col.collect(ts, torch.Generator(device=device).manual_seed(1), n_step=len(venv) * 4)  # warm-up
    t0 = time.perf_counter()
    stats = col.collect(ts, torch.Generator(device=device).manual_seed(2), n_step=n_step)
    dt = time.perf_counter() - t0
    return stats.n_collected_steps / dt


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env-ms", type=float, default=2.0, help="artificial env.step cost")
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--n-step", type=int, default=4000)
    return add_device_arg(ap)


def main(argv=None) -> dict[str, float]:
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv

    args = build_parser().parse_args(argv)
    dev, _ = setup(args.device, 0)
    algo = make_algo()
    ts = algo.init(dev)

    results = {}
    for name, cls in [("sequential", HostCollector), ("pipelined", PipelinedHostCollector)]:
        venv = SubprocVectorEnv([lambda: SleepyCartPole(args.env_ms) for _ in range(args.n_envs)])
        try:
            results[name] = run(cls, venv, algo, ts, args.n_step, dev)
        finally:
            venv.close()
        print(f"{name:>10}: {results[name]:,.0f} env-step/s "
              f"({args.n_envs} subproc envs, {args.env_ms}ms/step)", flush=True)
    print(f"  speedup: {results['pipelined'] / results['sequential']:.2f}x", flush=True)
    return results


if __name__ == "__main__":
    main()
