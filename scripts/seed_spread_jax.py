#!/usr/bin/env python3
"""The seed spread of a trained path in the JAX package on the CPU, and of the port on the JAX package's data.

    JAX_PLATFORMS=cpu python3 scripts/seed_spread_jax.py her --n-step 1 --seeds 0 1 2
    JAX_PLATFORMS=cpu python3 scripts/seed_spread_jax.py offline_pendulum --algos cql td3_bc --seeds 0 1 2 [--port]
        [--save-data FILE.npz | --data FILE.npz]

``her``: ``tests/test_her.py``'s ``run_goal_ddpg`` settings (HER, at most 8 epochs of 4,000 steps, stop at -12)
with the key ``jax.random.key(seed)``.

``offline_pendulum``: the Pendulum dataset gathered as ``tests/conftest.py:116-149`` gathers it (SAC trained to
-250 from ``key(--data-seed)``, 0 there, then 2,500 steps of 8 envs), then each algorithm trained at
``tests/test_offline.py:116-161``'s settings for its whole budget (no early stop) once per seed (``key(seed)``,
split as ``run_offline`` splits it; seed 1 is that test's key). With ``--port`` the port's algorithm
(``chip_smoke.build_offline_classic``) also trains on a copy of the same dataset on the CPU through
``chip_smoke.run_offline_classic`` from each seed. ``--save-data`` writes the dataset's rings to an ``.npz``
file and ``--data`` trains on the rings of such a file instead, as ``scripts/seed_spread.py`` does (so each
package can train on the other's dataset).

Prints each seed's best test reward and its test reward by epoch, then the median and how many seeds reach the
path's threshold. ``scripts/seed_spread.py`` gives the port's spread on a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys

import jax

jax.config.update("jax_platforms", "cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def summary(label: str, bests: list[float], threshold: float) -> str:
    hits = sum(b >= threshold for b in bests)
    return (f"{label}: best rewards {[round(b, 2) for b in bests]}, mean {statistics.mean(bests):.2f}, median "
            f"{statistics.median(bests):.2f}, {hits} of {len(bests)} seeds reach {threshold}")


def scorer(tests: list[float]):
    def score(stats) -> float:
        tests.append(float(stats.returns.mean()))
        return tests[-1]

    return score


def her(args) -> None:
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
        params = OffPolicyTrainerParams(
            max_epochs=8, epoch_num_steps=4000, test_step_num_episodes=20, batch_size=128,
            collection_step_num_env_steps=8, update_per_step=0.25, start_steps=2000, start_random=False,
            verbose=False, stop_fn=lambda r: r >= -12, compute_score_fn=scorer(tests))
        res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buffer.init(example), key)
        bests.append(res.best_reward)
        print(f"seed {seed} n_step {args.n_step}: best test reward {res.best_reward:.2f} after {res.epochs} epochs "
              f"(by epoch {[round(r, 2) for r in tests]})", flush=True)
    print(summary(f"n_step {args.n_step}", bests, -20.0))


def jax_dataset(data_seed: int):
    """``tests/conftest.py:pendulum_data`` from ``key(data_seed)``: (env, buffer, buffer state)."""
    import jax.numpy as jnp

    from tests.helpers import make_collectors, transition_example
    from tianshou_tpu.algorithm.modelfree.sac import SAC
    from tianshou_tpu.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu.data.collector import DeviceCollector
    from tianshou_tpu.env.classic.pendulum import Pendulum
    from tianshou_tpu.env.core import VectorDeviceEnv
    from tianshou_tpu.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
    from tianshou_tpu.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    env = Pendulum()
    algo = SAC(actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1, conditioned_sigma=True),
               critic=ContinuousCritic(hidden_sizes=(128, 128)), action_space=env.action_space,
               policy_optim=AdamOptimizerFactory(lr=3e-4), critic_optim=AdamOptimizerFactory(lr=3e-4), gamma=0.99,
               tau=0.005, alpha="auto")
    key = jax.random.key(data_seed)
    key, k1 = jax.random.split(key)
    ts = algo.init(k1, jnp.zeros(3))
    buffer = VectorReplayBuffer(total_size=50000, buffer_num=8)
    buf_state = buffer.init(transition_example(env))
    tc, ec = make_collectors(env, algo, buffer, n_train=8)
    params = OffPolicyTrainerParams(max_epochs=12, epoch_num_steps=4000, test_step_num_episodes=10, batch_size=128,
                                    collection_step_num_env_steps=8, update_per_step=0.5, start_steps=2000,
                                    start_random=False, stop_fn=lambda r: r >= -250, verbose=False)
    res = OffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, key)
    data = VectorReplayBuffer(total_size=20000, buffer_num=8)
    state = data.init(transition_example(env))
    coll = DeviceCollector(VectorDeviceEnv(env, 8), algo, data)
    key, kc, kr = jax.random.split(key, 3)
    _, state, _ = coll.collect(res.train_state, coll.reset(kr), state, kc, 2500, training=True)
    print(f"JAX dataset (key {data_seed}): SAC best {res.best_reward:.1f} after {res.epochs} epochs; reward per row "
          f"{float(state.data.rew.mean()):.4f}", flush=True)
    return env, data, state


def jax_offline(name: str, env, data, state, seed: int) -> list[float]:
    """The JAX package's algorithm on its dataset from ``key(seed)``: its test reward by epoch."""
    import jax.numpy as jnp

    from tests.helpers import make_collectors
    from tianshou_tpu.algorithm.imitation.cql import CQL
    from tianshou_tpu.algorithm.imitation.td3_bc import TD3BC
    from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as Adam
    from tianshou_tpu.models.continuous import ContinuousActorDeterministic, ContinuousActorProbabilistic
    from tianshou_tpu.models.continuous import ContinuousCritic
    from tianshou_tpu.trainer.trainer import OfflineTrainer, OfflineTrainerParams

    opts = dict(policy_optim=Adam(lr=3e-4), critic_optim=Adam(lr=3e-4))
    if name == "td3_bc":
        algo, epochs, batch = TD3BC(actor=ContinuousActorDeterministic(hidden_sizes=(128, 128), action_dim=1),
                                    critic=ContinuousCritic(hidden_sizes=(128, 128)), action_space=env.action_space,
                                    gamma=0.99, tau=0.005, alpha=2.5, **opts), 8, 64
    else:
        algo, epochs, batch = CQL(actor=ContinuousActorProbabilistic(hidden_sizes=(128, 128), action_dim=1,
                                                                     conditioned_sigma=True),
                                  critic=ContinuousCritic(hidden_sizes=(128, 128)), action_space=env.action_space,
                                  cql_weight=1.0, with_lagrange=True, num_repeat_actions=10, **opts), 10, 128
    key = jax.random.key(seed)
    key, k1 = jax.random.split(key)
    _, ec = make_collectors(env, algo, None)
    tests = []
    params = OfflineTrainerParams(max_epochs=epochs, update_step_num_gradient_steps_per_epoch=500, batch_size=batch,
                                  test_step_num_episodes=10, verbose=False, compute_score_fn=scorer(tests))
    OfflineTrainer(algo, data, ec, params).run(algo.init(k1, jnp.zeros(3)), state, key)
    return tests


def jax_data(arrays: dict):
    """The rings of ``arrays`` (``scripts/seed_spread.py``'s format) in a JAX buffer: (env, buffer, state)."""
    import jax.numpy as jnp

    from tests.helpers import transition_example
    from tianshou_tpu.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu.env.classic.pendulum import Pendulum
    from scripts.seed_spread import COUNTERS, FIELDS

    env = Pendulum()
    num, cap = arrays["rew"].shape
    data = VectorReplayBuffer(total_size=num * cap, buffer_num=num)
    state = data.init(transition_example(env))
    rings = state.data.copy()
    for k in FIELDS:
        setattr(rings, k, jnp.asarray(arrays[k], dtype=getattr(state.data, k).dtype))
    state = state._replace(data=rings, **{k: jnp.asarray(arrays[k], dtype=getattr(state, k).dtype) for k in COUNTERS})
    print(f"dataset of {int(arrays['size'].sum())} rows in {num} rings; reward per row "
          f"{float(arrays['rew'].mean()):.4f}", flush=True)
    return env, data, state


def offline_pendulum(args) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from scripts.seed_spread import dataset_arrays, port_dataset

    env, data, state = jax_data(dict(np.load(args.data))) if args.data else jax_dataset(args.data_seed)
    if args.save_data:
        np.savez(args.save_data, **dataset_arrays(state))
    port = port_dataset(cs, torch, dataset_arrays(state), "cpu")[:3] if args.port else None
    for name in args.algos:
        for side in ("jax", "port") if args.port else ("jax",):
            bests = []
            if side == "port":
                algo, epochs, batch = cs.build_offline_classic(torch, name, port[0])
            for seed in args.seeds:
                if side == "port":
                    tests = cs.run_offline_classic(torch, algo, *port, epochs, batch, seed, device="cpu")[1]
                else:
                    tests = jax_offline(name, env, data, state, seed)
                bests.append(max(tests))
                print(f"{side} {name} seed {seed}: best test reward {max(tests):.1f} (by epoch "
                      f"{[round(r, 1) for r in tests]})", flush=True)
            source = args.data or f"the JAX package's dataset from key {args.data_seed}"
            print(summary(f"{side} {name} on {source}", bests, cs.OFF_THRESHOLD["offline_pendulum"]), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", choices=["her", "offline_pendulum"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--n-step", type=int, default=1, help="her: the n-step return horizon")
    parser.add_argument("--algos", nargs="+", default=["td3_bc", "cql"], help="offline_pendulum: the algorithms")
    parser.add_argument("--data-seed", type=int, default=0, help="offline_pendulum: the dataset's key")
    parser.add_argument("--port", action="store_true", help="offline_pendulum: also train the port's algorithm")
    parser.add_argument("--save-data", help="offline_pendulum: write the dataset to this .npz file")
    parser.add_argument("--data", help="offline_pendulum: train on the dataset of this .npz file")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    {"her": her, "offline_pendulum": offline_pendulum}[args.path](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
