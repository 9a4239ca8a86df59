#!/usr/bin/env python3
"""The seed spread of HER-DDPG on GoalReach in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/her_seed_spread_jax.py --n-step 1 --seeds 0 1 2

Runs ``tests/test_her.py``'s ``run_goal_ddpg`` settings (HER, at most 8 epochs of 4,000 steps, stop at -12)
with the key ``jax.random.key(seed)`` for each seed and prints each seed's best test reward and its test
reward by epoch. ``scripts/her_seed_spread.py`` gives the port's spread on a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-step", type=int, default=1)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import tests.test_her as th
    from tests.helpers import make_collectors
    from tianshou_tpu.algorithm.modelfree.ddpg import DDPG
    from tianshou_tpu.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu.data.buffer.her import HERVectorReplayBuffer
    from tianshou_tpu.env.classic.goal_reach import GoalReach
    from tianshou_tpu.exploration.noise import GaussianNoise
    from tianshou_tpu.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    bests = []
    for seed in args.seeds:
        env = GoalReach(size=1.0, step_size=0.05, eps=0.05, max_episode_steps=60)
        algo = DDPG(actor=th.GoalActor(), critic=th.GoalCritic(), action_space=env.action_space,
                    policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3), gamma=0.98,
                    tau=0.005, exploration_noise=GaussianNoise(sigma=0.3), action_scaling=False,
                    n_step_return_horizon=args.n_step)
        key = jax.random.key(seed)
        key, k1 = jax.random.split(key)
        example = th.goal_tr(np.zeros(2), np.ones(2), np.zeros(2), -1.0, False)
        ts = algo.init(k1, example.obs)
        buffer = HERVectorReplayBuffer(total_size=50000, buffer_num=8, compute_reward_fn=env.compute_reward,
                                       horizon=60, future_k=8.0)
        tc, ec = make_collectors(env, algo, buffer, n_train=8, n_test=10)
        tests = []

        def score(stats, tests=tests) -> float:
            tests.append(float(stats.returns.mean()))
            return tests[-1]

        params = OffPolicyTrainerParams(
            max_epochs=8, epoch_num_steps=4000, test_step_num_episodes=20, batch_size=128,
            collection_step_num_env_steps=8, update_per_step=0.25, start_steps=2000, start_random=False,
            verbose=False, stop_fn=lambda r: r >= -12, compute_score_fn=score)
        res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buffer.init(example), key)
        bests.append(res.best_reward)
        print(f"seed {seed} n_step {args.n_step}: best test reward {res.best_reward:.2f} after {res.epochs} epochs "
              f"(by epoch {[round(r, 2) for r in tests]})", flush=True)
    print(f"n_step {args.n_step}: best rewards {[round(b, 2) for b in bests]}, mean {statistics.mean(bests):.2f}, "
          f"median {statistics.median(bests):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
