"""Host collect/update overlap benchmark, the port of ``examples/benchmark/host_overlap.py``.

Measures host-path SAC HalfCheetah (REAL Gymnasium MuJoCo: it needs ``gymnasium`` and ``mujoco``) steps/s in three
trainer configurations on the same step budget, through ``examples_torch/mujoco/_runner.py:run_offpolicy_host``:

  sync       -- plain ``HostCollector`` (Dummy venv) + blocking chunk updates
  pipelined  -- ``PipelinedHostCollector`` (subprocess env halves out of phase), blocking chunk updates
  overlap    -- pipelined + ``overlap_updates=True``: the gradient steps are launched from the collector's step
                hook, so that the device runs the update burst inside the env-step windows.

Appends one JSON line per mode to ``RESULTS`` (``examples_torch/benchmark/results/host_overlap.jsonl``) and
returns the overlap run's result (so that the seed queue can record it like any job).

Reference comparison: the reference trainer serializes collect and update around the torch forward
(trainer.py:316-365); there is no overlap there.

    python examples_torch/benchmark/host_overlap.py [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import json
import time
from pathlib import Path
from types import SimpleNamespace

from examples_torch.common import add_device_arg

RESULTS = Path(__file__).resolve().parent / "results" / "host_overlap.jsonl"


def make_algo(env):
    from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic

    nu, obs_dim = env.action_space.shape[0], env.observation_space.shape[0]
    return SAC(
        actor=ContinuousActorProbabilistic(hidden_sizes=(256, 256), action_dim=nu, conditioned_sigma=True,
                                           input_dim=obs_dim),
        critic=ContinuousCritic(hidden_sizes=(256, 256), input_dim=obs_dim, action_dim=nu),
        action_space=env.action_space,
        policy_optim=AdamOptimizerFactory(lr=1e-3),
        critic_optim=AdamOptimizerFactory(lr=1e-3),
        alpha=0.2, tau=0.005, gamma=0.99, n_step_return_horizon=1,
    )


def _one(mode: str, task: str, seed: int, epoch_num_steps: int, num_envs: int,
         chunk_len: int, update_per_step: float, batch_size: int, start_steps: int, device=None):
    from examples_torch.mujoco._runner import run_offpolicy_host

    t0 = time.time()
    res = run_offpolicy_host(
        make_algo, task, seed, epochs=1, epoch_num_steps=epoch_num_steps,
        num_envs=num_envs, batch_size=batch_size, start_steps=start_steps,
        chunk_len=chunk_len, update_per_step=update_per_step,
        test_episodes=2, verbose=False,
        pipelined=(mode != "sync"), overlap=(mode == "overlap"), device=device,
    )
    wall = time.time() - t0
    return res, wall


def train(seed: int = 0, task: str = "HalfCheetah", epoch_num_steps: int = 16_000,
          num_envs: int = 16, chunk_len: int = 8, update_per_step: float = 1.0,
          batch_size: int = 256, start_steps: int = 4_000, device=None):
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    rows = {}
    for mode in ("sync", "pipelined", "overlap"):
        res, wall = _one(mode, task, seed, epoch_num_steps, num_envs,
                         chunk_len, update_per_step, batch_size, start_steps, device)
        # train-loop steps/s excludes the random prefill + test episodes:
        # attribute collect+update time only
        loop_t = res.timing["collect"] + res.timing["update"]
        sps = epoch_num_steps / max(loop_t, 1e-9)
        rows[mode] = {
            "mode": mode, "task": task, "seed": seed,
            "env_step": int(res.env_step), "wall_s": round(wall, 1),
            "collect_s": round(res.timing["collect"], 2),
            "update_s": round(res.timing["update"], 2),
            "train_steps_per_s": round(sps, 1),
            "best_reward": float(res.best_reward),
            "finished_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        with RESULTS.open("a") as f:
            f.write(json.dumps(rows[mode]) + "\n")
        print(f"[host_overlap] {mode}: {sps:,.0f} steps/s "
              f"(collect {res.timing['collect']:.1f}s, update {res.timing['update']:.1f}s)",
              flush=True)
        last = res
    speedup = rows["overlap"]["train_steps_per_s"] / max(rows["sync"]["train_steps_per_s"], 1e-9)
    print(f"[host_overlap] overlap vs sync: {speedup:.2f}x", flush=True)
    return SimpleNamespace(best_reward=speedup, env_step=last.env_step)


def build_parser() -> argparse.ArgumentParser:
    return add_device_arg(argparse.ArgumentParser())


def main(argv=None):
    return train(device=build_parser().parse_args(argv).device)


if __name__ == "__main__":
    main()
