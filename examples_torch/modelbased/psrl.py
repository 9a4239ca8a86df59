"""PSRL (posterior sampling RL) on tabular device envs, the port of
``examples/modelbased/psrl.py`` (reference examples/modelbased/psrl.py:
Dirichlet transition posterior + Gaussian reward posterior, value-iteration
policy per posterior sample).

The device NChain env plays the role of the reference's NChain-v0; the
per-epoch posterior sample and value iteration run as one program.

    python examples_torch/modelbased/psrl.py --task NChain --epochs 10 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import time

from examples_torch.common import add_device_arg, setup


def train(
    task: str = "NChain",
    seed: int = 0,
    epochs: int = 10,
    epoch_num_steps: int = 2_000,
    num_envs: int = 8,
    rollout_len: int = 100,
    rew_mean_prior: float = 0.0,
    rew_std_prior: float = 1.0,
    add_done_loop: bool = False,
    value_iterations: int = 200,
    gamma: float = 0.95,
    test_episodes: int = 8,
    verbose: bool = True,
    logger=None,
    device=None,
):
    from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.classic.nchain import NChain
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    if task != "NChain":
        raise SystemExit(
            f"task {task!r}: the device example ships NChain (the reference's "
            "NChain-v0 analogue); FrozenLake/Taxi need gym's toy_text envs"
        )
    dev, gen = setup(device, seed)
    env = NChain(n=5, slip=0.2)
    algo = PSRL(
        n_state=5, n_action=2, action_space=env.action_space,
        gamma=gamma, add_done_loop=add_done_loop,
        value_iterations=value_iterations,
        rew_mean_prior=rew_mean_prior, rew_std_prior=rew_std_prior,
    )
    ts = algo.init(dev)
    tc = DeviceCollector(VectorDeviceEnv(env, num_envs, device=dev), algo, None)
    ec = DeviceCollector(VectorDeviceEnv(env, max(test_episodes, 8), device=dev), algo, None)
    params = OnPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=test_episodes, batch_size=1024,
        collection_step_num_env_steps=rollout_len,
        update_step_num_repetitions=1, logger=logger, verbose=verbose,
    )
    t0 = time.time()
    result = OnPolicyTrainer(algo, tc, ec, params).run(ts, gen)
    if verbose:
        print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
              f"({result.env_step / max(time.time() - t0, 1e-9):,.0f} steps/s)", flush=True)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="NChain")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--epoch-num-steps", type=int, default=2_000)
    p.add_argument("--rew-mean-prior", type=float, default=0.0)
    p.add_argument("--rew-std-prior", type=float, default=1.0)
    p.add_argument("--add-done-loop", action="store_true")
    return add_device_arg(p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    return train(**{k.replace("-", "_"): v for k, v in vars(args).items()})


if __name__ == "__main__":
    main()
