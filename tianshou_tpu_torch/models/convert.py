"""flax -> torch weight conversion for the Atari nets, the MLPs, the
discrete heads and the actor-critic nets (on-policy and continuous
off-policy).

Takes the parameter tree of a ``tianshou_tpu.models.atari`` net (``DQNet``,
``C51Net``, ``QRDQNet``, ``RainbowAtariNet``, ``ImplicitQuantileAtariNet``),
of a ``tianshou_tpu.models.mlp`` net (``MLP``, ``Net``, ``DuelingNet``,
``BranchingNet``, ``DictObsNet``), of a ``tianshou_tpu.models.discrete``
head (``RainbowNet``, ``ImplicitQuantileNetwork``,
``FractionProposalNetwork``, ``IntrinsicCuriosityModule``, ``MaskedQNet``)
of a ``tianshou_tpu.models.recurrent`` net (``RecurrentQNet``,
``RecurrentActorProb``, ``RecurrentCritic``) or of an actor-critic net
(``ContinuousActorProbabilistic``, ``ContinuousActorDeterministic``,
``ContinuousCritic``, ``EnsembleCritic``, ``DiscreteActor``,
``DiscreteCritic``, BCQ's ``Perturbation`` and ``VAE``, the pixel actor and
critic of the Atari and ViZDoom example scripts) with numpy leaves (``{"params": {...}}`` or the inner
``"params"`` dict) and returns a ``state_dict`` for its counterpart in
:mod:`tianshou_tpu_torch.models`. :func:`module_params_from_flax` picks the
converter by the torch module's class (a ``ModuleDict`` key by key),
:func:`train_state_from_flax` carries a whole JAX train state's ``params``
and ``target_params`` into a port train state built by the same algorithm
(a multi-agent one agent by agent), and :func:`marl_params_from_flax` maps
the multi-agent ``{"agent{i}": params}``. It needs no flax:

- conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
- Dense kernels ``[in, out]`` -> ``[out, in]``;
- ``EnsembleLinear`` keeps flax's ``[K, I, O]`` kernel and ``[K, 1, O]`` bias;
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
from torch import nn

__all__ = [
    "actor_critic_params_from_flax", "c51net_params_from_flax", "continuous_actor_det_params_from_flax",
    "continuous_actor_prob_params_from_flax", "continuous_critic_params_from_flax", "discrete_actor_params_from_flax",
    "discrete_critic_params_from_flax", "ensemble_critic_params_from_flax",
    "dqnet_params_from_flax", "mlp_params_from_flax", "nature_cnn_params_from_flax", "net_params_from_flax",
    "pixel_actor_params_from_flax", "pixel_critic_params_from_flax",
    "noisy_linear_params_from_flax", "rainbow_atari_params_from_flax", "qrdqnet_params_from_flax",
    "iqn_params_from_flax", "fraction_params_from_flax", "rainbow_net_params_from_flax",
    "branching_net_params_from_flax", "icm_params_from_flax", "masked_qnet_params_from_flax",
    "dict_obs_net_params_from_flax", "recurrent_params_from_flax", "perturbation_params_from_flax",
    "vae_params_from_flax", "module_params_from_flax", "marl_params_from_flax", "train_state_from_flax",
]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _conv(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))), _t(p["bias"])


def nature_cnn_params_from_flax(tree: dict, prefix: str = "",
                                flat_hw: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """``state_dict`` entries of a ``NatureCNN`` from its flax parameter dict
    (keys ``Conv_0..2`` and ``Dense_0``). ``flat_hw`` is the last conv's map
    (the torch net's ``flat_hw``: 5x8 for a 40x60 input); without it the map
    must be square (11x11 for 84x84)."""
    out: dict[str, torch.Tensor] = {}
    c_out = 0
    for i in range(3):
        w, b = _conv(tree[f"Conv_{i}"])
        out[f"{prefix}convs.{i}.weight"], out[f"{prefix}convs.{i}.bias"] = w, b
        c_out = w.shape[0]
    k = np.asarray(tree["Dense_0"]["kernel"])  # [H*W*C, F], rows in H, W, C order
    hw = k.shape[0] // c_out
    if flat_hw is None:
        h = math.isqrt(hw)
        if h * h != hw:
            raise ValueError(f"flatten width {k.shape[0]} is not a square map of {c_out} channels; give flat_hw")
        flat_hw = (h, h)
    if flat_hw[0] * flat_hw[1] != hw:
        raise ValueError(f"flatten width {k.shape[0]} is not a {flat_hw} map of {c_out} channels")
    k = k.reshape(*flat_hw, c_out, -1).transpose(2, 0, 1, 3).reshape(c_out * hw, -1)
    out[f"{prefix}fc.weight"] = _t(k.T)
    out[f"{prefix}fc.bias"] = _t(tree["Dense_0"]["bias"])
    return out


def dqnet_params_from_flax(tree: dict, flat_hw: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``DQNet`` (or ``C51Net``: the same scopes,
    a wider head) from the flax net's parameter tree; ``flat_hw`` as for
    :func:`nature_cnn_params_from_flax`."""
    p = tree["params"] if "params" in tree else tree
    out = nature_cnn_params_from_flax(p["NatureCNN_0"], prefix="cnn.", flat_hw=flat_hw)
    out["head.weight"] = _t(np.asarray(p["Dense_0"]["kernel"]).T)
    out["head.bias"] = _t(p["Dense_0"]["bias"])
    return out


c51net_params_from_flax = qrdqnet_params_from_flax = dqnet_params_from_flax
#: the pixel actor of the ViZDoom PPO script (``NatureCNN_0`` -> ``Dense_0``): a DQNet's scopes
pixel_actor_params_from_flax = dqnet_params_from_flax


def pixel_critic_params_from_flax(tree: dict, flat_hw: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """``state_dict`` of a pixel critic over a NatureCNN: the ViZDoom PPO
    script's (``NatureCNN_0`` and a bias-free ``w [F, 1]``, kept as it is)
    or the Atari runner's (``NatureCNN_0`` and ``Dense_0`` -> ``head``)."""
    p = _params(tree)
    out = nature_cnn_params_from_flax(p["NatureCNN_0"], prefix="cnn.", flat_hw=flat_hw)
    if "w" in p:
        out["w"] = _t(p["w"])
    else:
        out.update(_dense_params(p["Dense_0"], "head"))
    return out


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


def mlp_params_from_flax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """``state_dict`` entries of an ``MLP`` from its flax parameter dict
    (``Dense_i`` -> ``linears.i``, ``LayerNorm_i`` -> ``norms.i``)."""
    out: dict[str, torch.Tensor] = {}
    for name, p in tree.items():
        kind, i = name.rsplit("_", 1)
        if kind == "Dense":
            out[f"{prefix}linears.{i}.weight"] = _t(np.asarray(p["kernel"]).T)
            out[f"{prefix}linears.{i}.bias"] = _t(p["bias"])
        elif kind == "LayerNorm":
            out[f"{prefix}norms.{i}.weight"] = _t(p["scale"])
            out[f"{prefix}norms.{i}.bias"] = _t(p["bias"])
        else:
            raise ValueError(f"unexpected flax scope {name!r} in an MLP")
    return out


def net_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``MLP``, ``Net`` or ``DuelingNet`` from the
    flax net's parameter tree: an MLP holds ``Dense_*`` scopes, a ``Net`` one
    ``MLP_0``, a ``DuelingNet`` the trunk ``MLP_0`` and the heads ``MLP_1``
    (advantage) and ``MLP_2`` (value)."""
    p = tree["params"] if "params" in tree else tree
    if "MLP_0" not in p:
        return mlp_params_from_flax(p)
    if "MLP_1" not in p:
        return mlp_params_from_flax(p["MLP_0"], "mlp.")
    out = mlp_params_from_flax(p["MLP_0"], "feat.")
    out.update(mlp_params_from_flax(p["MLP_1"], "adv."))
    out.update(mlp_params_from_flax(p["MLP_2"], "val."))
    return out


def _dense_params(p: dict, name: str) -> dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(np.asarray(p["kernel"]).T), f"{name}.bias": _t(p["bias"])}


def continuous_actor_prob_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``ContinuousActorProbabilistic`` from the
    flax actor's tree: the trunk ``MLP_0``, the mu head ``Dense_0``, and the
    log-sigma head ``Dense_1`` (``conditioned_sigma``), the parameter
    ``log_sigma``, or gSDE's ``log_sigma_mat`` ``[F, A]`` (``sde``), as it is."""
    p = tree["params"] if "params" in tree else tree
    out = mlp_params_from_flax(p["MLP_0"], "mlp.")
    out.update(_dense_params(p["Dense_0"], "mu"))
    if "Dense_1" in p:
        out.update(_dense_params(p["Dense_1"], "sigma"))
    for name in ("log_sigma", "log_sigma_mat"):
        if name in p:
            out[name] = _t(p[name])
    return out


def continuous_critic_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``ContinuousCritic``, ``DiscreteActor`` or
    ``DiscreteCritic``: each holds one scope, ``MLP_0``."""
    p = tree["params"] if "params" in tree else tree
    return mlp_params_from_flax(p["MLP_0"], "mlp.")


discrete_actor_params_from_flax = discrete_critic_params_from_flax = continuous_critic_params_from_flax
continuous_actor_det_params_from_flax = continuous_critic_params_from_flax  # one scope, MLP_0, too


def ensemble_critic_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``EnsembleCritic`` from the flax critic's
    tree: scopes ``EnsembleLinear_i`` -> ``layers.i``, kernels and biases as
    they are."""
    p = tree["params"] if "params" in tree else tree
    out: dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        layer = p[f"EnsembleLinear_{i}"]
        out[f"layers.{i}.weight"], out[f"layers.{i}.bias"] = _t(layer["kernel"]), _t(layer["bias"])
    return out


def perturbation_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``Perturbation`` (one scope, ``MLP_0``)."""
    return mlp_params_from_flax(_params(tree)["MLP_0"], "mlp.")


def vae_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``VAE``: the flax module's ``setup`` names its
    scopes ``encoder`` and ``decoder`` (MLPs) and the Dense ``mean_head`` and
    ``logstd_head``, as the torch module names them."""
    p = _params(tree)
    out = mlp_params_from_flax(p["encoder"], "encoder.")
    out.update(mlp_params_from_flax(p["decoder"], "decoder."))
    for name in ("mean_head", "logstd_head"):
        out.update(_dense_params(p[name], name))
    return out


_ACTOR_CRITIC_CONVERTERS = {
    "ContinuousActorProbabilistic": continuous_actor_prob_params_from_flax,
    "ContinuousActorDeterministic": continuous_actor_det_params_from_flax,
    "ContinuousCritic": continuous_critic_params_from_flax,
    "EnsembleCritic": ensemble_critic_params_from_flax,
    "DiscreteActor": discrete_actor_params_from_flax,
    "DiscreteCritic": discrete_critic_params_from_flax,
    "Perturbation": perturbation_params_from_flax,
    "VAE": vae_params_from_flax,
}


#: the converters of nets over a NatureCNN, which read the torch net's map size (``cnn.flat_hw``)
_PIXEL_CONVERTERS = {"PixelActor": pixel_actor_params_from_flax, "PixelCritic": pixel_critic_params_from_flax}


def _convert_net(tree: dict, net) -> dict[str, torch.Tensor]:
    """``state_dict`` of one net (not a ``ModuleDict``) through the converter of its class."""
    cls = type(net).__name__
    if cls in _PIXEL_CONVERTERS:
        return _PIXEL_CONVERTERS[cls](tree, tuple(net.cnn.flat_hw))
    return _NET_CONVERTERS[cls](tree)


def actor_critic_params_from_flax(params: dict, model) -> dict[str, torch.Tensor]:
    """``state_dict`` of an actor-critic train state's ``model`` or
    ``target`` (a ``ModuleDict`` of ``actor``, ``critic``, ``critic2``, as
    the nets go) from the JAX train state's ``params`` or ``target_params``
    (``{"actor": tree, "critic": tree, ...}``), each net through the
    converter of its class; a 0-d ``log_alpha`` (SAC's and REDQ's
    ``alpha="auto"``) and CQL's ``log_cql_alpha`` are carried across where the
    model holds them."""
    out: dict[str, torch.Tensor] = {}
    for name, net in model.items():
        for k, v in _convert_net(params[name], net).items():
            out[f"{name}.{k}"] = v
    for name in ("log_alpha", "log_cql_alpha"):
        if hasattr(model, name):
            out[name] = _t(params[name])
    return out


def _params(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def iqn_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``ImplicitQuantileNetwork`` (an MLP trunk)
    or ``ImplicitQuantileAtariNet`` (a NatureCNN trunk, told apart by its
    ``Conv_0``) from the flax net's tree (scopes ``trunk``, ``cos_emb``,
    ``merge``, ``head``)."""
    p = _params(tree)
    trunk = p["trunk"]
    out = nature_cnn_params_from_flax(trunk, "trunk.") if "Conv_0" in trunk else mlp_params_from_flax(trunk, "trunk.")
    out.update(_dense_params(p["cos_emb"]["Dense_0"], "cos_emb.linear"))
    out.update(_dense_params(p["merge"], "merge"))
    out.update(_dense_params(p["head"], "head"))
    return out


def fraction_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``FractionProposalNetwork`` (scope ``Dense_0``)."""
    return _dense_params(_params(tree)["Dense_0"], "linear")


def rainbow_net_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of the torch MLP ``RainbowNet`` (scopes ``trunk``, an MLP,
    and the noisy ``v1``, ``v2``, ``a1``, ``a2``)."""
    p = _params(tree)
    out = mlp_params_from_flax(p["trunk"], "trunk.")
    for name in ("v1", "v2", "a1", "a2"):
        out.update(noisy_linear_params_from_flax(p[name], prefix=f"{name}."))
    return out


def branching_net_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``BranchingNet``: the trunk ``MLP_0``, the value
    head ``MLP_1`` and the branch layers ``EnsembleLinear_0`` / ``_1``."""
    p = _params(tree)
    out = mlp_params_from_flax(p["MLP_0"], "trunk.")
    out.update(mlp_params_from_flax(p["MLP_1"], "val."))
    for name, scope in (("branch", "EnsembleLinear_0"), ("adv", "EnsembleLinear_1")):
        out[f"{name}.weight"], out[f"{name}.bias"] = _t(p[scope]["kernel"]), _t(p[scope]["bias"])
    return out


def icm_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``IntrinsicCuriosityModule``: ``MLP_0`` ->
    ``phi``, ``MLP_1`` -> ``phi_next``, ``MLP_2`` -> ``forward_model``,
    ``MLP_3`` -> ``inverse_model`` (flax's order of creation)."""
    p = _params(tree)
    out: dict[str, torch.Tensor] = {}
    for i, name in enumerate(("phi", "phi_next", "forward_model", "inverse_model")):
        out.update(mlp_params_from_flax(p[f"MLP_{i}"], f"{name}."))
    return out


def masked_qnet_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``MaskedQNet`` (scope ``MLP_0``)."""
    return mlp_params_from_flax(_params(tree)["MLP_0"], "mlp.")


def dict_obs_net_params_from_flax(tree: dict, convert) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``DictObsNet``: the wrapped net's scope ``net``
    through ``convert``, the converter of the wrapped net's class."""
    return {f"net.{k}": v for k, v in convert(_params(tree)["net"]).items()}


def recurrent_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """``state_dict`` of a torch ``RecurrentQNet``, ``RecurrentActorProb`` or
    ``RecurrentCritic`` from the flax net's parameter tree. flax's
    ``OptimizedLSTMCell`` keeps one Dense per gate: ``ii/if/ig/io`` on the
    input (no bias) and ``hi/hf/hg/ho`` on the hidden state (with bias);
    ``torch.nn.LSTMCell`` stacks the gates in the same i, f, g, o order, so
    ``weight_ih`` and ``weight_hh`` are the transposed concatenations, the
    hidden gates' biases go to ``bias_hh`` and ``bias_ih`` is zero."""
    p = _params(tree)
    cell = p["core"]["cell"]
    out = {f"core.{k}": v for k, v in _dense_params(p["embed"], "embed").items()}
    gates = "ifgo"
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in gates], axis=1)
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in gates], axis=1)
    out["core.cell.weight_ih"] = _t(w_ih.T)
    out["core.cell.weight_hh"] = _t(w_hh.T)
    out["core.cell.bias_hh"] = _t(np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates]))
    out["core.cell.bias_ih"] = torch.zeros_like(out["core.cell.bias_hh"])
    for name in ("head", "mu", "sigma"):
        if name in p:
            out.update(_dense_params(p[name], name))
    return out


_NET_CONVERTERS = {
    **_ACTOR_CRITIC_CONVERTERS,
    "MLP": net_params_from_flax,
    "Net": net_params_from_flax,
    "DuelingNet": net_params_from_flax,
    "ImplicitQuantileNetwork": iqn_params_from_flax,
    "FractionProposalNetwork": fraction_params_from_flax,
    "RainbowNet": rainbow_net_params_from_flax,
    "BranchingNet": branching_net_params_from_flax,
    "IntrinsicCuriosityModule": icm_params_from_flax,
    "MaskedQNet": masked_qnet_params_from_flax,
}


def module_params_from_flax(tree: dict, module) -> dict[str, torch.Tensor]:
    """``state_dict`` of the torch ``module`` from the JAX parameters of its
    counterpart: a net through the converter of its class; a ``ModuleDict``
    key by key from the dict of the same keys (an ICM wrapper's
    ``"wrapped"`` from every key but ``"icm"``, as the JAX wrapper merges
    them), with ``log_alpha`` and ``log_cql_alpha`` where it holds them."""
    if not isinstance(module, nn.ModuleDict):
        return _convert_net(tree, module)
    out: dict[str, torch.Tensor] = {}
    for name, net in module.items():
        if name == "wrapped":
            sub = _model_params({k: v for k, v in tree.items() if k != "icm"}, net)
        else:
            sub = module_params_from_flax(tree[name], net)
        out.update({f"{name}.{k}": v for k, v in sub.items()})
    for name in ("log_alpha", "log_cql_alpha"):
        if hasattr(module, name):
            out[name] = _t(tree[name])
    return out


def _model_params(params: dict, module) -> dict[str, torch.Tensor]:
    """A train state's ``model`` (or ``target``) from the JAX ``params`` (or
    ``target_params``): a single net sits under ``"model"`` there."""
    if isinstance(module, nn.ModuleDict):
        return module_params_from_flax(params, module)
    return module_params_from_flax(params["model"], module)


def train_state_from_flax(jax_ts: Any, ts: Any) -> Any:
    """Load a JAX train state's ``params`` and ``target_params`` into the
    port train state ``ts`` of the same algorithm, in place (a multi-agent
    dict of train states agent by agent); returns ``ts``. The optimizer
    state, step and hyper-parameters stay the port's own (fresh at
    ``init``, as the JAX ones are)."""
    if isinstance(ts, dict):
        for k, sub in ts.items():
            train_state_from_flax(jax_ts[k], sub)
        return ts
    if len(ts.model.state_dict()):
        ts.model.load_state_dict(_model_params(jax_ts.params, ts.model))
    if ts.target is not None:
        ts.target.load_state_dict(_model_params(jax_ts.target_params, ts.target))
    return ts


def marl_params_from_flax(params: dict, algorithms) -> dict[str, dict[str, torch.Tensor]]:
    """``{"agent{i}": state_dict}`` of each agent's train state ``model``
    from the JAX multi-agent ``{"agent{i}": params}`` (the agents' JAX
    ``params`` dicts), each through the converter of the port agent's nets:
    a Q-learning agent's ``model`` (``masked_qnet_params_from_flax``, ...),
    an actor-critic agent's ``actor`` and ``critic``
    (``actor_critic_params_from_flax``); a parameterless agent maps to ``{}``."""
    out = {}
    for i, algo in enumerate(algorithms):
        p = params[f"agent{i}"]
        if getattr(algo, "model", None) is not None:
            out[f"agent{i}"] = _model_params(p, algo.model)
        elif getattr(algo, "actor", None) is not None:
            nets = {"actor": algo.actor, **({"critic": algo.critic} if getattr(algo, "critic", None) is not None else {})}
            out[f"agent{i}"] = actor_critic_params_from_flax(p, nn.ModuleDict(nets))
        else:
            out[f"agent{i}"] = {}
    return out
