"""Feed-forward nets (port of ``tianshou_tpu/models/mlp.py:23-128``; reference
utils/net/common.py): ``MLP`` (:90), ``Net`` (:246, ``num_atoms``
distributional heads, softmax, critic mode), ``DuelingNet`` (:319) and
``EnsembleLinear`` (:518, REDQ's critics).

flax infers a dense layer's input width at its first call; a torch layer is
made with it, so every net here takes ``input_dim`` (the flattened
observation width). Dense kernels start from flax's default (LeCun normal,
truncated), or with ``orthogonal_gain`` from an orthogonal matrix scaled by
that gain (flax's ``orthogonal(gain)``, the PPO recipe of
:mod:`tianshou_tpu_torch.models.continuous`), and biases from zero,
LayerNorm uses flax's epsilon of 1e-6, and
:func:`tianshou_tpu_torch.models.convert.net_params_from_flax` carries flax
weights across. ``EnsembleLinear`` keeps flax's ``[K, I, O]`` kernel and
``[K, 1, O]`` bias, and flax's LeCun normal counts the ensemble axis into the
fan-in (a receptive field of K), so each member starts at std
``1/sqrt(K * I)``, as in the JAX package. ``reset_parameters`` draws a net's
weights anew by the same rules (a second critic of the same shape).
``BranchingNet`` (:553, BDQN), ``RandomActor`` (:746) and ``DictObsNet``
with ``flatten_dict_obs`` (the reference's ``get_dict_state_decorator``,
:677) complete the module.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP", "Net", "DuelingNet", "EnsembleLinear", "BranchingNet", "RandomActor", "DictObsNet",
           "flatten_dict_obs"]


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    """flax's default kernel init: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _init_dense_(layer: nn.Linear, orthogonal_gain: float | None = None) -> None:
    if orthogonal_gain is None:
        _lecun_normal_(layer.weight, layer.in_features)
    else:
        nn.init.orthogonal_(layer.weight, gain=orthogonal_gain)
    nn.init.zeros_(layer.bias)


def _dense(in_features: int, out_features: int, orthogonal_gain: float | None = None) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    _init_dense_(layer, orthogonal_gain)
    return layer


class MLP(nn.Module):
    """Hidden layers with ``activation`` (and LayerNorm before it for
    ``norm="layer"``) after each, then an optional linear output head
    (reference MLP, net/common.py:90). ``output_dim=0``: the last hidden
    layer is the output. ``orthogonal_gain`` initializes every kernel,
    the head's too, as flax's ``orthogonal(gain)``."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int], output_dim: int = 0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu, norm: str | None = None,
                 flatten_input: bool = True, orthogonal_gain: float | None = None) -> None:
        super().__init__()
        if norm not in (None, "layer"):
            raise ValueError(f"norm must be None or 'layer', got {norm!r}")
        widths = [input_dim, *hidden_sizes]
        self.linears = nn.ModuleList(_dense(a, b, orthogonal_gain) for a, b in zip(widths, widths[1:]))
        self.norms = nn.ModuleList(nn.LayerNorm(h, eps=1e-6) for h in hidden_sizes) if norm == "layer" else None
        if output_dim > 0:
            self.linears.append(_dense(widths[-1], output_dim, orthogonal_gain))
        self.n_hidden = len(hidden_sizes)
        self.activation = activation
        self.flatten_input = flatten_input
        self.orthogonal_gain = orthogonal_gain
        self.output_dim = output_dim if output_dim > 0 else widths[-1]

    def reset_parameters(self) -> None:
        for layer in self.linears:
            _init_dense_(layer, self.orthogonal_gain)
        for norm in self.norms or ():
            norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.flatten_input and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        x = x.to(torch.float32)
        for i, layer in enumerate(self.linears):
            x = layer(x)
            if i < self.n_hidden:
                if self.norms is not None:
                    x = self.norms[i](x)
                x = self.activation(x)
        return x


class Net(nn.Module):
    """Q or feature net over flattened observations, optionally concatenated
    with actions (critic mode, ``action_dim`` wide), with ``num_atoms``
    outputs per action and an optional softmax over the last axis (reference
    Net, net/common.py:246)."""

    def __init__(self, hidden_sizes: Sequence[int], output_dim: int = 0, num_atoms: int = 1,
                 softmax: bool = False, concat_action: bool = False,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu, norm: str | None = None,
                 *, input_dim: int, action_dim: int = 0) -> None:
        super().__init__()
        self.output_dim = output_dim
        self.num_atoms = num_atoms
        self.softmax = softmax
        self.concat_action = concat_action
        width = input_dim + (action_dim if concat_action else 0)
        self.mlp = MLP(width, hidden_sizes, output_dim * num_atoms, activation=activation, norm=norm)

    def forward(self, obs: torch.Tensor, act: torch.Tensor | None = None) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1)
        if self.concat_action and act is not None:
            x = torch.cat([x.to(torch.float32), act.reshape(act.shape[0], -1).to(torch.float32)], dim=-1)
        x = self.mlp(x)
        if self.num_atoms > 1:
            x = x.reshape(x.shape[0], self.output_dim, self.num_atoms)
        if self.softmax:
            x = torch.softmax(x, dim=-1)
        return x


class DuelingNet(nn.Module):
    """Dueling Q head: ``Q = V + A - mean(A)`` over a shared MLP trunk
    (reference net/common.py:319)."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, num_atoms: int = 1,
                 dueling_hidden: Sequence[int] = (128,),
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu, *, input_dim: int) -> None:
        super().__init__()
        self.action_dim = action_dim
        self.num_atoms = num_atoms
        self.feat = MLP(input_dim, hidden_sizes, activation=activation)
        self.adv = MLP(self.feat.output_dim, dueling_hidden, action_dim * num_atoms)
        self.val = MLP(self.feat.output_dim, dueling_hidden, num_atoms)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        feat = self.feat(obs)
        adv, val = self.adv(feat), self.val(feat)
        if self.num_atoms > 1:
            adv = adv.reshape(-1, self.action_dim, self.num_atoms)
            val = val.reshape(-1, 1, self.num_atoms)
        return val + adv - adv.mean(dim=1, keepdim=True)


class EnsembleLinear(nn.Module):
    """``K`` independent linear layers in one batched product (reference
    EnsembleLinear, net/common.py:518): ``x [K, B, I]``, or ``[B, I]``
    broadcast to every member, times ``weight [K, I, O]``, plus
    ``bias [K, 1, O]`` -> ``[K, B, O]``."""

    def __init__(self, ensemble_size: int, in_features: int, features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ensemble_size, in_features, features))
        self.bias = nn.Parameter(torch.empty(ensemble_size, 1, features))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        k, i, _ = self.weight.shape
        _lecun_normal_(self.weight.data, k * i)  # flax counts the ensemble axis into the fan-in
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.weight.shape[0], *x.shape)
        return torch.bmm(x, self.weight) + self.bias


class BranchingNet(nn.Module):
    """Branching dueling Q-network (reference BranchingNet, net/common.py:553;
    BDQN): a shared trunk, one value head, and per-branch advantage heads as
    two :class:`EnsembleLinear` layers, ``[K, B, A]`` transposed to
    ``[B, K, A]``; ``Q = V + A - mean_a(A)`` per branch."""

    def __init__(self, hidden_sizes: Sequence[int], num_branches: int, action_per_branch: int,
                 value_hidden: Sequence[int] = (128,), branch_hidden: int = 128, *, input_dim: int) -> None:
        super().__init__()
        self.num_branches = num_branches
        self.action_per_branch = action_per_branch
        self.trunk = MLP(input_dim, hidden_sizes)
        self.val = MLP(self.trunk.output_dim, value_hidden, 1)
        self.branch = EnsembleLinear(num_branches, self.trunk.output_dim, branch_hidden)
        self.adv = EnsembleLinear(num_branches, branch_hidden, action_per_branch)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        feat = self.trunk(obs)
        val = self.val(feat)  # [B, 1]
        adv = self.adv(F.relu(self.branch(feat))).transpose(0, 1)  # [B, K, A]
        return val[:, :, None] + adv - adv.mean(dim=-1, keepdim=True)


class RandomActor(nn.Module):
    """A uniform-random "actor" (reference net/common.py:746): flat logits
    (discrete) or zero mean and unit sigma (continuous), whatever the
    observation."""

    def __init__(self, action_dim: int, discrete: bool = True) -> None:
        super().__init__()
        self.action_dim = action_dim
        self.discrete = discrete

    def forward(self, obs: torch.Tensor) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        shape = (obs.shape[0], self.action_dim)
        zeros = torch.zeros(shape, device=obs.device)
        return zeros if self.discrete else (zeros, torch.ones(shape, device=obs.device))


def _key_path_str(path: tuple[str, ...]) -> str:
    """``str`` of the JAX key path of a leaf, the key the JAX package sorts
    the leaves by: ``str`` of a tuple of ``DictKey``s."""
    return "(" + ", ".join(f"DictKey(key={k!r})" for k in path) + ("," if len(path) == 1 else "") + ")"


def _leaves_with_paths(obs, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    if isinstance(obs, torch.Tensor):
        return [(prefix, obs)]
    out = []
    for k, v in obs.items():
        out += _leaves_with_paths(v, prefix + (k,))
    return out


def flatten_dict_obs(obs) -> torch.Tensor:
    """A dict or Batch observation as one feature row per sample (the
    reference's ``get_dict_state_decorator``, net/common.py:677): every leaf
    raveled per sample and concatenated in the JAX package's order, sorted
    by the string of the leaf's JAX key path (``str`` of a tuple of
    ``DictKey``s, so a nested key sorts by ``"(DictKey(key='a'), ..."``,
    not by the plain key names)."""
    leaves = sorted(_leaves_with_paths(obs), key=lambda kv: _key_path_str(kv[0]))
    return torch.cat([v.reshape(v.shape[0], -1) for _, v in leaves], dim=-1)


class DictObsNet(nn.Module):
    """Any obs -> out module over dict or Batch observations, flattened by
    :func:`flatten_dict_obs` first (reference get_dict_state_decorator)."""

    def __init__(self, net: nn.Module) -> None:
        super().__init__()
        self.net = net

    def forward(self, obs, *args, **kwargs):
        if not isinstance(obs, torch.Tensor):
            obs = flatten_dict_obs(obs)
        return self.net(obs, *args, **kwargs)
