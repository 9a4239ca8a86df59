"""Shared runner for the port's MuJoCo high-level API examples (the twin of
``examples/mujoco/_hl.py``): parse the common CLI, build the experiment from
a builder class, run it on ``--device``, print the result.

Each mujoco_*_hl.py is a thin declaration of (builder class, Params,
training config), as the reference's high-level scripts are.
"""

from __future__ import annotations

import argparse

from examples_torch.common import add_device_arg
from tianshou_tpu_torch.env import mujoco as mj
from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OffPolicyTrainingConfig, OnPolicyTrainingConfig


def build_parser(**overrides) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default=overrides.get("task", "HalfCheetah"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=overrides.get("epochs", 10))
    p.add_argument("--epoch-num-steps", type=int, default=overrides.get("epoch_num_steps", 20_000))
    p.add_argument("--num-envs", type=int, default=overrides.get("num_envs", 16))
    p.add_argument("--buffer-size", type=int, default=overrides.get("buffer_size", 1_000_000))
    p.add_argument("--start-steps", type=int, default=overrides.get("start_steps", 10_000))
    p.add_argument("--watch", action="store_true")
    return add_device_arg(p)


def parse_args(argv=None, **overrides) -> argparse.Namespace:
    return build_parser(**overrides).parse_args(argv)


def offpolicy_training_config(args, **kw):
    return OffPolicyTrainingConfig(
        max_epochs=args.epochs,
        epoch_num_steps=args.epoch_num_steps,
        num_train_envs=args.num_envs,
        num_test_envs=10,
        buffer_size=args.buffer_size,
        start_timesteps=args.start_steps,
        start_timesteps_random=True,
        **kw,
    )


def onpolicy_training_config(args, **kw):
    kw.setdefault("collection_step_num_env_steps", 2048)
    kw.setdefault("update_step_num_repetitions", 10)
    kw.setdefault("batch_size", 64)
    return OnPolicyTrainingConfig(
        max_epochs=args.epochs,
        epoch_num_steps=args.epoch_num_steps,
        num_train_envs=args.num_envs,
        num_test_envs=10,
        **kw,
    )


def make_task(task: str):
    """The env factory of ``task`` (a module-level callable, so that an experiment pickles)."""
    import functools

    return functools.partial(mj.make, task)


def build(args, builder_cls, training, params=None, **builder_kw):
    """The builder of the experiment: ``builder_cls`` over the task with ``params`` and the
    ``with_*`` calls of ``builder_kw``."""
    builder = builder_cls(make_task(args.task), ExperimentConfig(seed=args.seed, watch=args.watch), training)
    if params is not None:
        builder.with_params(params)
    for k, v in builder_kw.items():
        getattr(builder, k)(v)
    return builder


def run(args, builder_cls, training, params=None, name=None, **builder_kw):
    builder = build(args, builder_cls, training, params, **builder_kw)
    name = name or f"{builder_cls.__name__.replace('ExperimentBuilder', '').lower()}_{args.task.lower()}"
    result = builder.build().run(name, device=args.device)
    print(f"best_reward={result.best_reward:.1f}", flush=True)
    return result
