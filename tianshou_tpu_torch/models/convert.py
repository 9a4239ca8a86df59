"""flax -> torch weight conversion for the Atari nets.

Takes the parameter tree of a ``tianshou_tpu.models.atari`` net (``DQNet``,
``C51Net``, ``RainbowAtariNet``) with numpy leaves (``{"params": {...}}`` or
the inner ``"params"`` dict) and returns a ``state_dict`` for its
counterpart in :mod:`tianshou_tpu_torch.models.atari`. It needs no flax:

- conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
- Dense kernels ``[in, out]`` -> ``[out, in]``;
- the first Dense after the flatten has its rows permuted from the JAX
  net's H, W, C flatten order to the torch net's C, H, W order;
- noisy layers: flax keeps ``mu_w [in, out]`` and ``mu_b`` uncentred and
  subtracts ``1/sqrt(in)`` in its forward; the torch layer stores the
  centred means as ``[out, in]``, so the shift is applied here.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

__all__ = [
    "c51net_params_from_flax", "dqnet_params_from_flax", "nature_cnn_params_from_flax",
    "noisy_linear_params_from_flax", "rainbow_atari_params_from_flax",
]


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
    """``state_dict`` of a torch ``DQNet`` (or ``C51Net``: the same scopes,
    a wider head) from the flax net's parameter tree."""
    p = tree["params"] if "params" in tree else tree
    out = nature_cnn_params_from_flax(p["NatureCNN_0"], prefix="cnn.")
    out["head.weight"] = _t(np.asarray(p["Dense_0"]["kernel"]).T)
    out["head.bias"] = _t(p["Dense_0"]["bias"])
    return out


c51net_params_from_flax = dqnet_params_from_flax


def noisy_linear_params_from_flax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """``state_dict`` entries of a ``NoisyLinear`` from its flax parameter
    dict (``mu_w``, ``mu_b``, ``sigma_w``, ``sigma_b``)."""
    mu_w = np.asarray(tree["mu_w"], dtype=np.float32)
    shift = np.float32(1.0) / np.sqrt(np.float32(mu_w.shape[0]))
    return {
        f"{prefix}mu_w": _t((mu_w - shift).T),
        f"{prefix}mu_b": _t(np.asarray(tree["mu_b"], dtype=np.float32) - shift),
        f"{prefix}sigma_w": _t(np.asarray(tree["sigma_w"]).T),
        f"{prefix}sigma_b": _t(tree["sigma_b"]),
    }


def rainbow_atari_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``RainbowAtariNet`` from the flax net's
    parameter tree (scopes ``trunk``, ``v1``, ``v2``, ``a1``, ``a2``)."""
    p = tree["params"] if "params" in tree else tree
    out = nature_cnn_params_from_flax(p["trunk"], prefix="trunk.")
    for name in ("v1", "v2", "a1", "a2"):
        out.update(noisy_linear_params_from_flax(p[name], prefix=f"{name}."))
    return out
