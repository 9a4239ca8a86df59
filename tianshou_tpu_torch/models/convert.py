"""flax -> torch weight conversion for the Atari nets.

Takes the parameter tree of ``tianshou_tpu.models.atari.DQNet`` with numpy
leaves (``{"params": {"NatureCNN_0": {...}, "Dense_0": {...}}}``, or the
inner ``"params"`` dict) and returns a ``state_dict`` for
:class:`tianshou_tpu_torch.models.atari.DQNet`. It needs no flax:

- conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
- Dense kernels ``[in, out]`` -> ``[out, in]``;
- the first Dense after the flatten has its rows permuted from the JAX
  net's H, W, C flatten order to the torch net's C, H, W order.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

__all__ = ["dqnet_params_from_flax", "nature_cnn_params_from_flax"]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _conv(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))), _t(p["bias"])


def nature_cnn_params_from_flax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """``state_dict`` entries of a ``NatureCNN`` from its flax parameter dict
    (keys ``Conv_0..2`` and ``Dense_0``)."""
    out: dict[str, torch.Tensor] = {}
    c_out = 0
    for i in range(3):
        w, b = _conv(tree[f"Conv_{i}"])
        out[f"{prefix}convs.{i}.weight"], out[f"{prefix}convs.{i}.bias"] = w, b
        c_out = w.shape[0]
    k = np.asarray(tree["Dense_0"]["kernel"])  # [H*W*C, F], rows in H, W, C order
    hw = k.shape[0] // c_out
    h = math.isqrt(hw)
    if h * h != hw:
        raise ValueError(f"flatten width {k.shape[0]} is not a square map of {c_out} channels")
    k = k.reshape(h, h, c_out, -1).transpose(2, 0, 1, 3).reshape(c_out * hw, -1)
    out[f"{prefix}fc.weight"] = _t(k.T)
    out[f"{prefix}fc.bias"] = _t(tree["Dense_0"]["bias"])
    return out


def dqnet_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``DQNet`` from a flax ``DQNet`` parameter tree."""
    p = tree["params"] if "params" in tree else tree
    out = nature_cnn_params_from_flax(p["NatureCNN_0"], prefix="cnn.")
    out["head.weight"] = _t(np.asarray(p["Dense_0"]["kernel"]).T)
    out["head.bias"] = _t(p["Dense_0"]["bias"])
    return out
