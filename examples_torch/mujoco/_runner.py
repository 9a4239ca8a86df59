"""Shared scaffolding for the port's MuJoCo-class example scripts (the twin of
``examples/mujoco/_runner.py``): env and model construction, trainer wiring,
and the argparse surface of the reference's examples/mujoco scripts.

The device runs step the port's MuJoCo envs (``tianshou_tpu_torch.env.mujoco``,
one ``physics_fused`` kernel launch per vector step on the card). The
``*_host`` variants run the real Gymnasium MuJoCo envs and need
``gymnasium`` and ``mujoco``; without them they raise ``ImportError``.
``--device`` (``cuda`` by default) takes the place of the JAX scripts'
``force_cpu``; ``--cpu`` is kept as a spelling of ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from examples_torch.common import add_device_arg, setup, transition_example


def build_env(task: str, norm_obs: bool = False):
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.env.wrappers import NormObs

    env = make(task)
    return NormObs(env) if norm_obs else env


def _steps_per_s(result, t0: float) -> float:
    return result.env_step / max(time.time() - t0, 1e-9)


def run_offpolicy(make_algo, task, seed, epochs, epoch_num_steps, num_envs,
                  batch_size, start_steps, buffer_size=1_000_000, chunk_len=4,
                  update_per_step=1.0, test_episodes=10, verbose=True, logger=None, device=None, fused=True):
    """make_algo(env) -> off-policy Algorithm; trains with the reference's
    off-policy protocol (prefill, 1 grad step per env step by default);
    ``fused``: each collect chunk and its update burst as one program."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OffPolicyTrainer, OffPolicyTrainerParams

    dev, gen = setup(device, seed)
    env = build_env(task)
    nu = env.action_space.shape[0]
    obs_dim = env.observation_space.shape[0]
    algo = make_algo(env)
    ts = algo.init(dev)
    buffer = VectorReplayBuffer(total_size=buffer_size, buffer_num=num_envs)
    buf_state = buffer.init(transition_example(torch.zeros(obs_dim), torch.zeros(nu)), device=dev)
    train_c = DeviceCollector(VectorDeviceEnv(env, num_envs, device=dev), algo, buffer)
    test_c = DeviceCollector(VectorDeviceEnv(env, max(test_episodes, 10), device=dev), algo, None)
    params = OffPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=test_episodes, batch_size=batch_size,
        collection_step_num_env_steps=chunk_len, update_per_step=update_per_step,
        start_steps=start_steps, start_random=True, fused_megastep=fused,
        logger=logger, verbose=verbose,
    )
    t0 = time.time()
    result = OffPolicyTrainer(algo, train_c, test_c, buffer, params).run(ts, buf_state, gen)
    if verbose:
        print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
              f"({_steps_per_s(result, t0):,.0f} steps/s)", flush=True)
    return result


def run_onpolicy(make_algo, task, seed, epochs, epoch_num_steps, num_envs,
                 rollout_len, repeat, batch_size, norm_obs=True,
                 test_episodes=10, verbose=True, logger=None, device=None):
    """make_algo(env) -> on-policy Algorithm; reference on-policy protocol."""
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.trainer.trainer import OnPolicyTrainer, OnPolicyTrainerParams

    dev, gen = setup(device, seed)
    env = build_env(task, norm_obs=norm_obs)
    # test envs evaluate under FROZEN train obs-norm statistics (reference
    # VectorEnvNormObs(update_obs_rms=False) sharing the train rms)
    test_env = env
    if norm_obs:
        from tianshou_tpu_torch.env.wrappers import NormObs

        test_env = NormObs(env.env, update_stats=False)
    algo = make_algo(env)
    ts = algo.init(dev)
    train_c = DeviceCollector(VectorDeviceEnv(env, num_envs, device=dev), algo, None)
    test_c = DeviceCollector(VectorDeviceEnv(test_env, max(test_episodes, 10), device=dev), algo, None)
    params = OnPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=test_episodes, batch_size=batch_size,
        collection_step_num_env_steps=rollout_len,
        update_step_num_repetitions=repeat, logger=logger, verbose=verbose,
    )
    t0 = time.time()
    result = OnPolicyTrainer(algo, train_c, test_c, params).run(ts, gen)
    if verbose:
        print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
              f"({_steps_per_s(result, t0):,.0f} steps/s)", flush=True)
    return result


def offpolicy_argparser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default=defaults.get("task", "HalfCheetah"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=defaults.get("epochs", 50))
    p.add_argument("--epoch-num-steps", type=int, default=defaults.get("epoch_num_steps", 20_000))
    p.add_argument("--num-envs", type=int, default=defaults.get("num_envs", 32))
    p.add_argument("--batch-size", type=int, default=defaults.get("batch_size", 256))
    p.add_argument("--start-steps", type=int, default=defaults.get("start_steps", 10_000))
    return add_device_arg(p)


def make_train(make_algo, **script_defaults):
    """Build a ``train(seed=..., **overrides)`` entry point for an on-policy
    example script, so that a seed runner can drive it the same way it
    drives the off-policy scripts' ``train``."""
    def train(seed=0, logger=None, **kwargs):
        cfg = dict(task="HalfCheetah", epochs=30, epoch_num_steps=100_000,
                   num_envs=256, rollout_len=64, repeat=1, batch_size=4096)
        cfg.update(script_defaults)
        cfg.update(kwargs)
        return run_onpolicy(make_algo, seed=seed, logger=logger, **cfg)
    return train


def onpolicy_argparser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default=defaults.get("task", "HalfCheetah"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=defaults.get("epochs", 30))
    p.add_argument("--epoch-num-steps", type=int, default=defaults.get("epoch_num_steps", 100_000))
    p.add_argument("--num-envs", type=int, default=defaults.get("num_envs", 256))
    p.add_argument("--rollout-len", type=int, default=defaults.get("rollout_len", 64))
    p.add_argument("--repeat", type=int, default=defaults.get("repeat", 1))
    p.add_argument("--batch-size", type=int, default=defaults.get("batch_size", 4096))
    return add_device_arg(p)


def add_backend_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The ``--backend`` and ``--cpu`` options of the SAC, TD3 and PPO scripts."""
    p.add_argument("--backend", choices=["device", "host"], default="device",
                   help="device = the port's physics envs; host = REAL Gymnasium MuJoCo envs")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return p


def script_kwargs(args: argparse.Namespace) -> dict:
    """The parsed options as keywords of ``train`` / ``run_*``: dashes to underscores, ``--cpu`` folded
    into ``device``."""
    kw = {k.replace("-", "_"): v for k, v in vars(args).items()}
    if kw.pop("cpu", False):
        kw["device"] = "cpu"
    return kw


def main_offpolicy(make_algo, argv=None, **defaults):
    """The ``__main__`` of an off-policy script: parse and train."""
    args = offpolicy_argparser(**defaults).parse_args(argv)
    return run_offpolicy(make_algo, **script_kwargs(args))


def main_onpolicy(make_algo, argv=None, **defaults):
    """The ``__main__`` of an on-policy script: parse and train."""
    args = onpolicy_argparser(**defaults).parse_args(argv)
    return run_onpolicy(make_algo, **script_kwargs(args))


def _gym_spec(task: str):
    """(factory of the Gymnasium ``{task}-v4`` env, an env spec with the port's spaces for the algorithm)."""
    import gymnasium as gym

    from tianshou_tpu_torch.env.core import Box

    gym_id = f"{task}-v4"

    def make():
        return gym.make(gym_id)

    probe = make()
    obs_dim = probe.observation_space.shape[0]
    nu = probe.action_space.shape[0]
    probe.close()

    class _EnvSpec:  # minimal spec with the port's Space types for the algorithm
        observation_space = Box(low=[-float("inf")] * obs_dim, high=[float("inf")] * obs_dim)
        action_space = Box(low=[-1.0] * nu, high=[1.0] * nu)

    return make, _EnvSpec(), gym_id


def run_offpolicy_host(make_algo, task, seed, epochs, epoch_num_steps, num_envs,
                       batch_size, start_steps, buffer_size=1_000_000,
                       chunk_len=8, update_per_step=1.0, test_episodes=10,
                       verbose=True, logger=None, pipelined=False, overlap=False, device=None):
    """Same protocol as :func:`run_offpolicy` but on the REAL Gymnasium
    MuJoCo envs (requires ``gymnasium`` and ``mujoco``) through the host
    collector, the exact benchmark environment of the reference tables.

    ``pipelined=True`` uses subprocess env workers with the two-phase
    :class:`PipelinedHostCollector`, overlapping device policy compute
    with host env stepping."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer, OffPolicyTrainerParams

    make, spec, gym_id = _gym_spec(task)
    dev, gen = setup(device, seed)
    obs_dim, nu = spec.observation_space.shape[0], spec.action_space.shape[0]
    algo = make_algo(spec)
    ts = algo.init(dev)
    buffer = VectorReplayBuffer(total_size=buffer_size, buffer_num=num_envs)
    buf_state = buffer.init(transition_example(torch.zeros(obs_dim), torch.zeros(nu)), device=dev)
    if pipelined:
        tc = PipelinedHostCollector(SubprocVectorEnv([make for _ in range(num_envs)]), algo, buffer, device=dev)
    else:
        tc = HostCollector(DummyVectorEnv([make for _ in range(num_envs)]), algo, buffer, device=dev)
    ec = HostCollector(DummyVectorEnv([make for _ in range(test_episodes)]), algo, None, device=dev)
    params = OffPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=test_episodes, batch_size=batch_size,
        collection_step_num_env_steps=chunk_len, update_per_step=update_per_step,
        start_steps=start_steps, start_random=True, logger=logger,
        verbose=verbose, seed=seed, overlap_updates=overlap,
    )
    t0 = time.time()
    result = HostOffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, gen)
    if verbose:
        print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
              f"({_steps_per_s(result, t0):,.0f} steps/s) [real MuJoCo {gym_id}]", flush=True)
    return result


def run_onpolicy_host(make_algo, task, seed, epochs, epoch_num_steps, num_envs,
                      batch_size, rollout_len=256, repeat=10, test_episodes=10,
                      verbose=True, logger=None, device=None):
    """On-policy (PPO-family) training on the REAL Gymnasium MuJoCo envs
    (reference mujoco_ppo.py protocol: shared VectorEnvNormObs obs_rms
    updated on train and frozen on test, 2048-step collects)."""
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.venvs import DummyVectorEnv, VectorEnvNormObs
    from tianshou_tpu_torch.trainer.trainer import HostOnPolicyTrainer, OnPolicyTrainerParams

    make, spec, gym_id = _gym_spec(task)
    dev, gen = setup(device, seed)
    algo = make_algo(spec)
    ts = algo.init(dev)
    train_venv = VectorEnvNormObs(DummyVectorEnv([make for _ in range(num_envs)]))
    test_venv = VectorEnvNormObs(DummyVectorEnv([make for _ in range(test_episodes)]), update_obs_rms=False)
    test_venv.set_obs_rms(train_venv.get_obs_rms())  # shared, frozen on test
    tc = HostCollector(train_venv, algo, device=dev)
    ec = HostCollector(test_venv, algo, None, device=dev)
    params = OnPolicyTrainerParams(
        max_epochs=epochs, epoch_num_steps=epoch_num_steps,
        test_step_num_episodes=test_episodes, batch_size=batch_size,
        collection_step_num_env_steps=rollout_len,
        update_step_num_repetitions=repeat,
        logger=logger, verbose=verbose, seed=seed,
    )
    t0 = time.time()
    result = HostOnPolicyTrainer(algo, tc, ec, params).run(ts, gen)
    if verbose:
        print(f"best_reward={result.best_reward:.1f} env_steps={result.env_step} "
              f"({_steps_per_s(result, t0):,.0f} steps/s) [real MuJoCo {gym_id}]", flush=True)
    return result
