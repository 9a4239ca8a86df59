"""Multi-process scaling over ``torch.distributed`` (port of
``tianshou_tpu/parallel/distributed.py``).

This replaces the reference's ``RayVectorEnv`` / ``RayEnvWorker`` cluster path
(reference env/venvs.py:449-473, env/worker/ray.py): every process runs the
same program over its own slice of the envs and of the replay ring, and the
processes meet in one process group. On the card the group's backend is NCCL,
one process per GPU (NCCL puts no two ranks on one GPU); ``device="cpu"``
gives a gloo group of CPU processes, which is how the tests run two or four
ranks on one machine (``tests/test_torch_distributed.py``).

Nothing on a machine tells a program of its cluster: the caller passes the
coordinator's address (``host:port``, or a full ``init_method`` URL such as
``file:///path``), the world size and this process's rank.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = [
    "initialize",
    "make_global_mesh",
    "process_env_slice",
    "host_local_to_global",
    "global_to_host_local",
]


def _init_method(coordinator_address: str) -> str:
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Join the process group (idempotent).

    ``device=None`` means the card: an NCCL group over GPU ``local_device_ids[0]``
    (default: ``process_id`` modulo the GPUs present), and an error where there
    is no GPU. ``device="cpu"`` gives a gloo group. A second call with the same
    world size and rank does nothing; another world raises.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for an NCCL group; pass device='cpu' for a gloo group")
    if dist.is_initialized():
        same = (dist.get_world_size(), dist.get_rank(), dist.get_backend()) == (num_processes, process_id, backend)
        if not same:
            raise RuntimeError(
                f"the process group is already initialised as rank {dist.get_rank()} of {dist.get_world_size()} "
                f"({dist.get_backend()}), not rank {process_id} of {num_processes} ({backend})")
        return
    if backend == "nccl":
        gpu = local_device_ids[0] if local_device_ids else process_id % torch.cuda.device_count()
        torch.cuda.set_device(gpu)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)


def mesh_device_type() -> str:
    """``"cuda"`` for an NCCL group, ``"cpu"`` for a gloo one."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_global_mesh(axis_name: str = "dp") -> DeviceMesh:
    """1-D data-parallel mesh over every process of the group."""
    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def process_env_slice(total_envs: int) -> tuple[int, int]:
    """``(start, count)`` of the env indices this process owns.

    Envs are split contiguously by rank, so that a ``[E, ...]`` global tensor
    sharded on its leading axis has exactly this process's rows locally.
    """
    n, pid = dist.get_world_size(), dist.get_rank()
    assert total_envs % n == 0, f"total_envs={total_envs} must divide by the world size {n}"
    per = total_envs // n
    return pid * per, per


def _leading_placements(mesh: DeviceMesh, axis_name: str) -> list:
    return [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_local_to_global(local: Any, mesh: DeviceMesh, axis_name: str = "dp") -> Any:
    """A global ``DTensor`` per leaf, sharded on its leading axis over
    ``axis_name``, from each process's local rows (numpy arrays or tensors)."""
    placements = _leading_placements(mesh, axis_name)
    dev = _mesh_device(mesh)

    def build(x: Any) -> DTensor:
        return DTensor.from_local(torch.as_tensor(np.asarray(x), device=dev), mesh, placements, run_check=False)

    return tree_map(build, local)


def global_to_host_local(global_tree: Any) -> Any:
    """This process's rows of each leading-axis-sharded global leaf, as numpy."""

    def take(x: Any) -> np.ndarray:
        local = x.to_local() if isinstance(x, DTensor) else x
        return local.detach().cpu().numpy()

    return tree_map(take, global_tree)
