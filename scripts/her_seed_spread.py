#!/usr/bin/env python3
"""The seed spread of HER-DDPG on GoalReach in the port, on one GPU.

    python3 scripts/her_seed_spread.py --n-step 1 --seeds 0 1 2 3

Trains ``chip_smoke.py``'s ``her_ddpg_goal_reach`` path (``tests/test_her.py:110-145``'s settings: GoalReach,
128x128 goal nets, HER over a 50,000-row replay, at most 8 epochs of 4,000 steps) once per seed through the
graphed ``OffPolicyTrainer`` and prints each seed's best test reward and its test reward by epoch, with the
card's name and power limit. ``scripts/her_seed_spread_jax.py`` gives the JAX package's spread on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-step", type=int, default=1)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("her_seed_spread: this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._smi(), flush=True)
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
    print(f"n_step {args.n_step}: best rewards {[round(b, 2) for b in bests]}, mean {statistics.mean(bests):.2f}, "
          f"median {statistics.median(bests):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
