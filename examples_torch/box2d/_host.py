"""What the port's Box2D host examples share: the Gymnasium env factory and the host trainer's run."""

from __future__ import annotations

import functools



def gym_factory(task: str, **kwargs):
    """A picklable factory of the Gymnasium env ``task`` (its Box2D envs need ``gymnasium[box2d]``); raises
    ``ImportError`` now where gymnasium is absent."""
    import gymnasium as gym

    return functools.partial(gym.make, task, **kwargs)


def run_host(algo, factory, num_envs: int, test_envs: int, buffer_size: int, example: Batch, params, device,
             generator):
    """``algo`` through ``HostOffPolicyTrainer`` over ``SubprocVectorEnv`` s of ``factory`` (``num_envs`` train,
    ``test_envs`` test) and a replay of ``buffer_size`` rows; the workers are closed after the run."""
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv
    from tianshou_tpu_torch.trainer.trainer import HostOffPolicyTrainer

    ts = algo.init(device)
    buffer = VectorReplayBuffer(total_size=buffer_size, buffer_num=num_envs)
    buf_state = buffer.init(example, device=device)
    venvs = [SubprocVectorEnv([factory for _ in range(num_envs)]), SubprocVectorEnv([factory for _ in range(test_envs)])]
    try:
        tc = HostCollector(venvs[0], algo, buffer, device=device)
        ec = HostCollector(venvs[1], algo, None, device=device)
        res = HostOffPolicyTrainer(algo, tc, ec, buffer, params).run(ts, buf_state, generator)
    finally:
        for venv in venvs:
            venv.close()
    print(f"best_reward={res.best_reward:.1f} env_steps={res.env_step}", flush=True)
    return res
