"""DQN on Atari through the host path, the port of ``examples/atari/atari_dqn.py``
(NatureCNN, 84x84x4 uint8 frames, eps 1 -> 0.05 over 1M steps, target sync
500, n-step 3). Needs ale-py and the ROMs.

Without them the JAX script runs ``bench.py``, a JAX program. This port
instead trains its DQN on the synthetic catch game through
``_runner.run_offpolicy`` (the device pixel pipeline), as its sibling
scripts do, with ``_runner``'s defaults for the settings this script has
no option for.

    python examples_torch/atari/atari_dqn.py --task PongNoFrameskip-v4 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse

from examples_torch.atari import _runner
from examples_torch.common import add_device_arg, setup
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.models.atari import DQNet


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="PongNoFrameskip-v4")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--buffer-size", type=int, default=100_000)
    return add_device_arg(p)


def make_algo(args, n: int):
    return DQN(
        model=DQNet(action_dim=n),
        action_space=Discrete(n),
        optim=AdamOptimizerFactory(lr=args.lr),
        gamma=0.99, n_step_return_horizon=3, target_update_freq=500,
        eps_training=1.0, eps_inference=0.005,
    )


def run_host(args, algo):
    """The JAX script's host run: 10 test envs, epochs of 100,000 steps, a 50,000-step prefill."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.atari import make_atari_env
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainerParams

    def factory():
        return make_atari_env(args.task)

    device, gen = setup(args.device, args.seed)
    ts = algo.init(device)
    buffer = _runner.make_buffer(args, host=True)
    buf_state = buffer.init(_runner.frame_example(_runner.FRAME[:2]), device=device)
    tc = HostCollector(DummyVectorEnv([factory for _ in range(args.num_envs)]), algo, buffer, device=device)
    ec = HostCollector(DummyVectorEnv([factory for _ in range(10)]), algo, None, device=device)
    params = OffPolicyTrainerParams(
        max_epochs=args.epochs, epoch_num_steps=100_000, test_step_num_episodes=10,
        batch_size=32, collection_step_num_env_steps=10, update_per_step=0.1,
        start_steps=50_000,
        train_fn=lambda ep, step: {"eps_training": max(0.05, 1.0 - step / 1_000_000)},
        verbose=True, seed=args.seed,
    )
    res = HostOffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    print(f"best_reward={res.best_reward:.1f} env_steps={res.env_step}", flush=True)
    return res


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup(args.device, args.seed)  # raises without a GPU unless --device cpu; seeds the nets' weights
    n = _runner.ale_actions(args.task)
    if n is not None:
        return run_host(args, make_algo(args, n))
    _runner.say_fallback(args.task)
    # the catch game, with _runner's defaults for what this parser lacks
    full = _runner.parse_args([])
    vars(full).update(vars(args))
    return _runner._run_offpolicy_device(full, make_algo(full, 3), stop_reward=4.0)


if __name__ == "__main__":
    main()
