"""What every port example shares: the ``--device`` option and the seeding of a run."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["add_device_arg", "setup", "transition_example"]


def add_device_arg(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--device``, ``cuda`` by default: the run raises without a GPU unless ``--device cpu`` is given."""
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a GPU) or cpu")
    return p


def setup(device: str | torch.device | None, seed: int) -> tuple[torch.device, torch.Generator]:
    """The run's device (``utils/device.py:resolve_device``: it raises when a GPU is asked for and there
    is none) and its generator on that device; torch's and numpy's global generators, which draw the
    nets' initial weights, are seeded with ``seed`` too. Call it before the nets are built."""
    dev = resolve_device(device)
    torch.manual_seed(seed)
    np.random.seed(seed)
    return dev, torch.Generator(device=dev).manual_seed(seed)


def transition_example(obs, act: torch.Tensor) -> Batch:
    """One transition of observation ``obs`` (a tensor or a ``Batch``) and action ``act``: the layout a replay
    buffer's ``init`` takes."""
    obs_next = obs.map(torch.clone) if isinstance(obs, Batch) else obs.clone()
    return Batch(obs=obs, act=act, rew=torch.tensor(0.0), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=obs_next)
