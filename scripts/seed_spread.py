#!/usr/bin/env python3
"""The seed spread of a trained path of the port, on one GPU: each seed's best test reward.

    python3 scripts/seed_spread.py her --n-step 1 --seeds 0 1 2 3
    python3 scripts/seed_spread.py offline_pendulum --algos td3_bc cql --seeds 0 1 2 3 [--data-seed 0]
        [--save-data FILE.npz | --data FILE.npz]

``her``: ``chip_smoke.py``'s ``her_ddpg_goal_reach`` path (``tests/test_her.py:110-145``'s settings: GoalReach,
128x128 goal nets, HER over a 50,000-row replay, at most 8 epochs of 4,000 steps, stop at -12) once per seed
through the graphed ``OffPolicyTrainer``.

``offline_pendulum``: ``chip_smoke.py``'s Pendulum dataset once (``expert_dataset``: SAC trained to -250 from
``--data-seed``, then 2,500 steps of 8 envs, as ``tests/conftest.py:116-149`` gathers it from seed 0), then each
algorithm of ``tests/test_offline.py:116-161`` (``chip_smoke.build_offline_classic``) once per seed through
``chip_smoke.run_offline_classic`` for its whole budget (no early stop). Seed s starts from the weights and the
generator of ``chip_smoke.py``'s run of seed s; its line also gives the test reward of those initial weights
(10 episodes, as an epoch's test phase). ``--save-data`` writes the dataset's rings to an ``.npz`` file;
``--data`` trains on the rings of such a file instead of gathering (``scripts/seed_spread_jax.py`` writes and reads
the same format, so each package can train on the other's dataset).

Prints each seed's best test reward and its test reward by epoch, then the median and how many seeds reach the
path's threshold, with the card's name and power limit. ``scripts/seed_spread_jax.py`` gives the JAX package's
spread on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys


FIELDS, COUNTERS = ("obs", "act", "rew", "terminated", "truncated", "obs_next", "done"), ("size", "cursor", "last_idx")


def dataset_arrays(state) -> dict:
    """A Pendulum dataset's rings (``[E, C, ...]``) and counters (``[E]``) as numpy arrays, from a buffer state of
    either package."""
    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    return {**{k: host(getattr(state.data, k)) for k in FIELDS}, **{k: host(getattr(state, k)) for k in COUNTERS}}


def port_dataset(cs, torch, arrays: dict, device: str):
    """The rings of ``arrays`` in a port buffer on ``device``: (env, buffer, buffer state, report line)."""
    from tianshou_tpu_torch.env.classic.pendulum import Pendulum

    env = Pendulum()
    num, cap = arrays["rew"].shape
    buffer, bs = cs._classic_buffer(torch, env, num * cap, num, device=device)
    for k in FIELDS:
        getattr(bs.data, k).copy_(torch.from_numpy(arrays[k]))
    for k in COUNTERS:
        getattr(bs, k).copy_(torch.from_numpy(arrays[k]).long())
    return env, buffer, bs, (f"dataset of {int(arrays['size'].sum())} rows in {num} rings; reward per row "
                             f"{float(arrays['rew'].mean()):.4f}")


def summary(label: str, bests: list[float], threshold: float) -> str:
    hits = sum(b >= threshold for b in bests)
    return (f"{label}: best rewards {[round(b, 2) for b in bests]}, mean {statistics.mean(bests):.2f}, median "
            f"{statistics.median(bests):.2f}, {hits} of {len(bests)} seeds reach {threshold}")


def her(cs, torch, args) -> None:
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    bests = []
    for seed in args.seeds:
        algo, buffer, example, tc, ec = cs.build_her(torch, args.n_step, seed)
        tests = []

        def score(stats, tests=tests) -> float:
            tests.append(float(stats.returns.mean()))
            return tests[-1]

        params = OffPolicyTrainerParams(
            max_epochs=cs.HER_EPOCHS, epoch_num_steps=cs.HER_EPOCH_STEPS, test_step_num_episodes=20,
            batch_size=cs.HER_BATCH, collection_step_num_env_steps=cs.HER_T, update_per_step=cs.HER_UPS,
            start_steps=cs.HER_PREFILL, start_random=False, stop_fn=lambda r: r >= -12, compute_score_fn=score,
            verbose=False)
        res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(
            algo.init("cuda"), buffer.init(example, device="cuda"), torch.Generator(device="cuda").manual_seed(seed))
        bests.append(res.best_reward)
        print(f"seed {seed} n_step {args.n_step}: best test reward {res.best_reward:.2f} after {res.epochs} epochs "
              f"(by epoch {[round(r, 2) for r in tests]})", flush=True)
    print(summary(f"n_step {args.n_step}", bests, cs.HER_THRESHOLD))


def untrained(torch, algo, env, seed: int) -> float:
    """The test reward of seed ``seed``'s initial weights: 10 episodes on 10 envs, as an epoch's test phase."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv

    torch.manual_seed(seed)
    ts = algo.init("cuda")
    coll = DeviceCollector(VectorDeviceEnv(env, 10, device="cuda"), algo, None)
    stats = coll.collect_episodes(ts, torch.Generator(device="cuda").manual_seed(seed), 10, training=False)
    return float(stats.returns.mean())


def offline_pendulum(cs, torch, args) -> None:
    import numpy as np

    if args.data:
        env, data, state, line = port_dataset(cs, torch, dict(np.load(args.data)), "cuda")
        line = f"{args.data}: {line}"
    else:
        env, data, state, _, line = cs.expert_dataset(torch, "pendulum", seed=args.data_seed)
    print(line, flush=True)
    if args.save_data:
        np.savez(args.save_data, **dataset_arrays(state))
    for name in args.algos:
        algo, epochs, batch = cs.build_offline_classic(torch, name, env)
        bests = []
        for seed in args.seeds:
            res, tests, _ = cs.run_offline_classic(torch, algo, env, data, state, epochs, batch, seed, device="cuda")
            bests.append(res.best_reward)
            print(f"{name} seed {seed}: best test reward {res.best_reward:.1f} (by epoch "
                  f"{[round(r, 1) for r in tests]}; untrained {untrained(torch, algo, env, seed):.1f})", flush=True)
        print(summary(name, bests, cs.OFF_THRESHOLD["offline_pendulum"]), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", choices=["her", "offline_pendulum"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--n-step", type=int, default=1, help="her: the n-step return horizon")
    parser.add_argument("--algos", nargs="+", default=["td3_bc", "cql"], help="offline_pendulum: the algorithms")
    parser.add_argument("--data-seed", type=int, default=0, help="offline_pendulum: the dataset's seed")
    parser.add_argument("--save-data", help="offline_pendulum: write the dataset to this .npz file")
    parser.add_argument("--data", help="offline_pendulum: train on the dataset of this .npz file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("seed_spread: this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._smi(), flush=True)
    {"her": her, "offline_pendulum": offline_pendulum}[args.path](cs, torch, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
