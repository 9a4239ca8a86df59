"""Checkpoints and persistence (port of ``tianshou_tpu/utils/persistence.py``;
reference SURVEY.md §5).

- Train-state checkpoints: the model's and the target's ``state_dict``, the
  optimizers' state (``Algorithm.state_dict``, algorithm_base.py:523-543),
  the hyper-parameters, the carried ``extra`` and the step counter, in one
  ``torch.save`` file inside the checkpoint directory (the JAX package
  writes an orbax directory). A multi-agent train state (a dict of train
  states) is saved agent by agent. :func:`restore_train_state` writes the
  checkpoint into a train state of the same structure, in place.
- Replay-buffer states to HDF5 (buffer_base.py:252-263) in the JAX
  package's layout (``_write_tree`` / ``_read_tree``: a group per state or
  ``Batch``, its type in ``__type__``, a ``Batch``'s key order in
  ``__keys__``), so that a file written by either package is read by the
  other; :func:`buffer_from_data` and the d4rl loaders build a buffer from
  flat offline arrays (:265-295).

``h5py`` is imported only by the functions that read or write HDF5.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = [
    "save_train_state",
    "restore_train_state",
    "save_buffer_hdf5",
    "load_buffer_hdf5",
    "buffer_from_data",
    "buffer_from_d4rl",
    "load_d4rl_hdf5",
]

_TS_FILE = "train_state.pt"


def _optim_state(optim: Any) -> Any:
    if isinstance(optim, dict):
        return {k: _optim_state(v) for k, v in optim.items()}
    return optim.state_dict()


def _ts_payload(ts: Any) -> dict:
    if isinstance(ts, dict):
        return {"__agents__": {k: _ts_payload(v) for k, v in ts.items()}}
    return {
        "model": ts.model.state_dict(),
        "target": None if ts.target is None else ts.target.state_dict(),
        "optim": _optim_state(ts.optim),
        "hparams": dict(ts.hparams),
        "extra": dict(ts.extra),
        "step": ts.step,
    }


def save_train_state(path: str, ts: TrainState | dict) -> str:
    """Write ``ts`` (its optimizers' state included) into the directory
    ``path``; returns the directory's absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(_ts_payload(ts), os.path.join(path, _TS_FILE))
    return path


def _load_optim(optim: Any, state: Any) -> None:
    if isinstance(optim, dict):
        for k, v in optim.items():
            _load_optim(v, state[k])
    else:
        optim.load_state_dict(state)


def _load_scalars(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor]) -> None:
    for k, v in src.items():
        if k in dst:
            dst[k].copy_(v)
        else:
            dst[k] = v.clone()


def _restore(ts: Any, payload: dict) -> Any:
    if isinstance(ts, dict):
        for k, v in ts.items():
            _restore(v, payload["__agents__"][k])
        return ts
    ts.model.load_state_dict(payload["model"])
    if ts.target is not None:
        ts.target.load_state_dict(payload["target"])
    _load_optim(ts.optim, payload["optim"])
    with torch.no_grad():
        _load_scalars(ts.hparams, payload["hparams"])
        _load_scalars(ts.extra, payload["extra"])
        ts.step.copy_(payload["step"])
    return ts


def restore_train_state(path: str, ts_template: TrainState | dict) -> TrainState | dict:
    """Write the checkpoint in the directory ``path`` into ``ts_template``
    (from ``algo.init``, on any device) in place, and return it."""
    some = ts_template if not isinstance(ts_template, dict) else next(iter(ts_template.values()))
    payload = torch.load(os.path.join(os.path.abspath(path), _TS_FILE), map_location=some.step.device,
                         weights_only=False)
    return _restore(ts_template, payload)


# ---------------------------------------------------------------------------
# HDF5 buffer persistence (reference buffer_base.py:252, utils/converter.py), the JAX package's layout
# ---------------------------------------------------------------------------

#: the integer index fields of a ring's state, int64 in the port (int32 in a JAX file)
_INDEX_FIELDS = ("cursor", "size", "last_idx")


def _fields(tree: Any) -> tuple[str, ...] | None:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple state
        return tree._fields
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(f.name for f in dataclasses.fields(tree))
    return None


def _write_tree(group, name: str, tree: Any) -> None:
    fields = _fields(tree)
    if fields is not None:
        sub = group.create_group(name)
        sub.attrs["__type__"] = type(tree).__name__
        for k in fields:
            _write_tree(sub, k, getattr(tree, k))
    elif isinstance(tree, Batch):
        sub = group.create_group(name)
        sub.attrs["__type__"] = "Batch"
        sub.attrs["__keys__"] = json.dumps(list(tree.keys()))
        for k, v in tree.items():
            _write_tree(sub, k, v)
    else:
        group.create_dataset(name, data=tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree))


def _state_type(name: str):
    from tianshou_tpu_torch.data.buffer.cached import CachedState
    from tianshou_tpu_torch.data.buffer.prio import PrioState

    return {"BufferState": BufferState, "PrioState": PrioState, "CachedState": CachedState}[name]


def _read_tree(node, device: torch.device) -> Any:
    import h5py

    if isinstance(node, h5py.Group):
        typ = node.attrs.get("__type__", "Batch")
        if typ == "Batch":
            keys = node.attrs.get("__keys__")
            order = json.loads(keys) if keys is not None else list(node)
            b = Batch()
            for k in order:
                b[k] = _read_tree(node[k], device)
            return b
        fields = {k: _read_tree(node[k], device) for k in node}
        for k in _INDEX_FIELDS:
            if k in fields:
                fields[k] = fields[k].to(torch.int64)
        return _state_type(typ)(**fields)
    return torch.as_tensor(np.asarray(node)).to(device)


def save_buffer_hdf5(path: str, state: Any) -> None:
    """Persist any buffer state (a plain ``BufferState``, a PER ``PrioState``
    with its sum tree and max/min priority, a ``CachedState``), as the
    reference saves whole buffers (buffer_base.py:252-263)."""
    import h5py

    with h5py.File(path, "w") as f:
        _write_tree(f, "state", state)


def load_buffer_hdf5(path: str, device: str | torch.device | None = None) -> Any:
    """The buffer state in ``path`` (written by either package) on ``device``."""
    import h5py

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        if "state" in f:
            return _read_tree(f["state"], dev)
        # the JAX package's first layout (flat BufferState fields)
        return BufferState(data=_read_tree(f["data"], dev),
                           **{k: torch.as_tensor(np.asarray(f[k])).to(dev, torch.int64) for k in _INDEX_FIELDS})


def _leaf(x: Any, device: torch.device) -> torch.Tensor:
    """A dataset column as a tensor on ``device``; float64 becomes float32,
    as ``jnp.asarray`` makes it."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


def buffer_from_data(
    buffer_cls,
    obs: np.ndarray,
    act: np.ndarray,
    rew: np.ndarray,
    terminated: np.ndarray,
    truncated: np.ndarray,
    obs_next: np.ndarray,
    device: str | torch.device | None = None,
) -> tuple[Any, BufferState]:
    """A full one-ring buffer on ``device`` from flat offline arrays
    (reference ReplayBuffer.from_data, buffer_base.py:265)."""
    dev = resolve_device(device)
    n = len(obs)
    buf = buffer_cls(n) if not hasattr(buffer_cls, "capacity") else buffer_cls
    done = np.logical_or(terminated, truncated)
    data = Batch(
        obs=_leaf(obs, dev)[None], act=_leaf(act, dev)[None], rew=_leaf(np.asarray(rew, np.float32), dev)[None],
        terminated=_leaf(terminated, dev)[None], truncated=_leaf(truncated, dev)[None], done=_leaf(done, dev)[None],
        obs_next=_leaf(obs_next, dev)[None],
    )
    state = BufferState(
        data=data,
        cursor=torch.zeros(1, dtype=torch.int64, device=dev),
        size=torch.full((1,), n, dtype=torch.int64, device=dev),
        last_idx=torch.full((1,), n - 1, dtype=torch.int64, device=dev),
    )
    return buf, state


def buffer_from_d4rl(dataset, buffer_cls=None, device: str | torch.device | None = None) -> tuple[Any, BufferState]:
    """A buffer from a d4rl-layout dataset (an in-memory dict or an open
    ``h5py.File``): ``observations / actions / rewards / terminals /
    next_observations`` and, if present, ``timeouts``: the contract of
    ``d4rl.qlearning_dataset`` that the reference's offline examples read
    (reference examples/offline/utils.py:10-33)."""
    from tianshou_tpu_torch.data.buffer.base import ReplayBuffer

    terminals = np.asarray(dataset["terminals"], bool)
    timeouts = np.asarray(dataset["timeouts"], bool) if "timeouts" in dataset else np.zeros(len(terminals), bool)
    return buffer_from_data(
        buffer_cls or ReplayBuffer,
        obs=np.asarray(dataset["observations"]),
        act=np.asarray(dataset["actions"]),
        rew=np.asarray(dataset["rewards"]),
        terminated=terminals,
        truncated=timeouts & ~terminals,
        obs_next=np.asarray(dataset["next_observations"]),
        device=device,
    )


def load_d4rl_hdf5(path: str, buffer_cls=None, device: str | torch.device | None = None) -> tuple[Any, BufferState]:
    """A buffer from a d4rl-format HDF5 file (reference
    examples/offline/utils.py:23 ``load_buffer``)."""
    import h5py

    with h5py.File(path, "r") as f:
        return buffer_from_d4rl(f, buffer_cls, device)
