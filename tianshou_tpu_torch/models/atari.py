"""Atari network family (port of ``tianshou_tpu/models/atari.py``; reference
env/atari/atari_network.py: ``DQNet:60`` NatureCNN, ``C51Net:125``,
``RainbowNet:154`` noisy dueling, ``QRDQNet:211``) and the implicit-quantile
head of IQN and FQF over the NatureCNN trunk (``ImplicitQuantileAtariNet``).

The public layout is the JAX package's: observations are NHWC
``[B, H, W, C]`` or frame-stacked ``[B, L, H, W, C]`` (the stack folded into
channels as ``c * L + l``), uint8 frames are scaled by 1/255 inside the net,
and the default compute type is bf16 with a float32 output. Inside, the net
is NCHW. The convolutions pad ``SAME`` as flax ``nn.Conv`` does, which is
asymmetric for the second one (kernel 4, stride 2 on 21 pixels pads 1 before
and 2 after), so an 84x84 input flattens to 11*11*64 = 7744 features in
C, H, W order. :mod:`tianshou_tpu_torch.models.convert` permutes flax
weights into this layout.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.models.discrete import Noise, NoisyLinear, _QuantileHead
from tianshou_tpu_torch.models.mlp import _lecun_normal_

__all__ = ["NatureCNN", "DQNet", "C51Net", "QRDQNet", "ImplicitQuantileAtariNet", "RainbowAtariNet", "same_out",
           "same_pads"]


def same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial dim under ``SAME`` (flax/XLA)."""
    total = max((same_out(n, stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class NatureCNN(nn.Module):
    """conv 32x8s4 - 64x4s2 - 64x3s1 - dense ``features`` over [B, 84, 84, C]."""

    _CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (out channels, kernel, stride)

    def __init__(
        self,
        in_channels: int = 4,
        features: int = 512,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input_hw = tuple(input_hw)
        convs, c, (h, w) = [], in_channels, self.input_hw
        for out, k, s in self._CONVS:
            convs.append(nn.Conv2d(c, out, k, stride=s))
            c, h, w = out, same_out(h, s), same_out(w, s)
        self.convs = nn.ModuleList(convs)
        self.flat_hw = (h, w)
        self.fc = nn.Linear(c * h * w, features)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        for m in (*self.convs, self.fc):
            _lecun_normal_(m.weight, m.weight[0].numel())
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd) / 255.0 if x.dtype == torch.uint8 else x.to(cd)
        if x.dim() == 5:  # frame-stacked [B, L, H, W, C] -> fold L into channels
            x = x.movedim(1, -1).reshape(x.shape[0], x.shape[2], x.shape[3], -1)
        if x.shape[1] in (1, 4) and x.shape[-1] not in (1, 4):
            x = x.permute(0, 2, 3, 1)  # accept NCHW input, as the JAX net does
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs:
            k, s = conv.kernel_size[0], conv.stride[0]
            ph, pw = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = F.relu(F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=s))
        x = x.flatten(1)
        x = F.relu(F.linear(x, self.fc.weight.to(cd), self.fc.bias.to(cd)))
        return x.to(torch.float32)


class DQNet(nn.Module):
    """NatureCNN -> Q values (reference atari_network.py:60). The head is a
    float32 ``Linear``, as the JAX net's default-typed ``Dense``."""

    def __init__(
        self,
        action_dim: int,
        features: int = 512,
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.cnn = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.head = nn.Linear(features, action_dim)
        self.reset_parameters(trunk=False)

    def reset_parameters(self, trunk: bool = True) -> None:
        """New weights by the rules of construction (a second critic of the same shape)."""
        if trunk:
            self.cnn.reset_parameters()
        _lecun_normal_(self.head.weight, self.head.in_features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.cnn(x))


class C51Net(nn.Module):
    """NatureCNN -> categorical atoms (reference atari_network.py:125):
    ``[B, action_dim, num_atoms]`` probabilities, softmax over the atoms."""

    def __init__(
        self,
        action_dim: int,
        num_atoms: int = 51,
        features: int = 512,
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.action_dim, self.num_atoms = action_dim, num_atoms
        self.cnn = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.head = nn.Linear(features, action_dim * num_atoms)
        _lecun_normal_(self.head.weight, features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.head(self.cnn(x))
        return F.softmax(logits.reshape(-1, self.action_dim, self.num_atoms), dim=-1)


class QRDQNet(nn.Module):
    """NatureCNN -> quantiles ``[B, action_dim, num_quantiles]`` (reference
    atari_network.py:211); the head a float32 ``Linear``."""

    def __init__(
        self,
        action_dim: int,
        num_quantiles: int = 200,
        features: int = 512,
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.action_dim, self.num_quantiles = action_dim, num_quantiles
        self.cnn = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.head = nn.Linear(features, action_dim * num_quantiles)
        _lecun_normal_(self.head.weight, features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.cnn(x)).reshape(-1, self.action_dim, self.num_quantiles)


class ImplicitQuantileAtariNet(_QuantileHead):
    """The NatureCNN trunk (bf16 by default, float32 features) with the
    cosine embedding of the fractions: ``Q(tau)`` ``[B, K, action_dim]``, the
    Atari IQN / FQF head. ``features`` and ``quantiles`` apart, as
    :class:`tianshou_tpu_torch.models.discrete.ImplicitQuantileNetwork`."""

    def __init__(
        self,
        action_dim: int,
        features_dim: int = 512,
        num_cosines: int = 64,
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.trunk = NatureCNN(in_channels, features_dim, compute_dtype, input_hw)
        self._make_head(features_dim, action_dim, num_cosines)


class RainbowAtariNet(nn.Module):
    """NatureCNN -> noisy dueling distributional head (reference
    atari_network.py:154): value stream ``v1 -> v2`` over the atoms,
    advantage stream ``a1 -> a2`` over actions x atoms, mean-advantage
    subtraction, softmax over the atoms.

    ``forward(x, noise)``: ``None`` uses the mean weights; a
    ``torch.Generator`` draws fresh factorized noise for each of the four
    noisy layers, in the order v1, v2, a1, a2; a sequence of four
    ``(eps_in, eps_out)`` pairs in that order is used as given.
    """

    def __init__(
        self,
        action_dim: int,
        num_atoms: int = 51,
        features: int = 512,
        sigma0: float = 0.5,
        in_channels: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        input_hw: tuple[int, int] = (84, 84),
    ) -> None:
        super().__init__()
        self.action_dim, self.num_atoms = action_dim, num_atoms
        self.trunk = NatureCNN(in_channels, features, compute_dtype, input_hw)
        self.v1 = NoisyLinear(features, features, sigma0)
        self.v2 = NoisyLinear(features, num_atoms, sigma0)
        self.a1 = NoisyLinear(features, features, sigma0)
        self.a2 = NoisyLinear(features, action_dim * num_atoms, sigma0)

    def forward(self, x: torch.Tensor,
                noise: torch.Generator | Sequence[Noise] | None = None) -> torch.Tensor:
        feat = self.trunk(x)
        n = [noise] * 4 if noise is None or isinstance(noise, torch.Generator) else noise
        v = self.v2(F.relu(self.v1(feat, n[0])), n[1]).reshape(-1, 1, self.num_atoms)
        a = self.a2(F.relu(self.a1(feat, n[2])), n[3]).reshape(-1, self.action_dim, self.num_atoms)
        logits = v + a - a.mean(dim=1, keepdim=True)
        return F.softmax(logits, dim=-1)
