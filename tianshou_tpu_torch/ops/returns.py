"""Return and advantage estimation (port of ``tianshou_tpu/ops/returns.py``).

- ``gae_advantages``     <- reference ``_gae``                    (algorithm_base.py:1085-1140)
- ``nstep_returns``      <- reference ``_nstep_return``           (algorithm_base.py:1160-1222)
- ``mc_return_to_go``    <- reference ``episode_mc_return_to_go`` (algorithm_base.py:1143-1157)
- ``value_mask``         <- reference ``Algorithm.value_mask``    (algorithm_base.py:633-651)

All take time-major tensors ``[T, ...]``. Each reversed ``lax.scan`` of the
JAX module is a reversed Python loop over the short time axis, with the
trailing batch dimensions carried as tensors.
"""

from __future__ import annotations

import torch

__all__ = ["gae_advantages", "nstep_returns", "mc_return_to_go", "value_mask"]


def value_mask(terminated: torch.Tensor) -> torch.Tensor:
    """1.0 where the next-state value should bootstrap: zero only on true
    termination; truncation (time limit) still bootstraps."""
    return 1.0 - terminated.to(torch.float32)


def _reverse_scan(x: torch.Tensor, cont: torch.Tensor) -> torch.Tensor:
    """``g[t] = x[t] + cont[t] * g[t+1]`` with ``g[T] = 0``."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + cont[t] * carry
        out[t] = carry
    return out


def gae_advantages(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    episode_end: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> torch.Tensor:
    """Generalized advantage estimation.

    Args (all time-major ``[T, ...]``): rewards, values (V(s_t)),
    next_values (V(s_{t+1}), unmasked), terminated (episode truly ended at
    t), episode_end (terminated OR truncated OR rollout boundary: the
    advantage chain is cut). Returns advantages ``[T, ...]``.
    """
    rewards = rewards.to(torch.float32)
    next_values = next_values * value_mask(terminated)
    delta = rewards + gamma * next_values - values
    discount = (1.0 - episode_end.to(torch.float32)) * (gamma * gae_lambda)
    return _reverse_scan(delta, discount)


def mc_return_to_go(
    rewards: torch.Tensor,
    gamma: float,
    episode_end: torch.Tensor | None = None,
) -> torch.Tensor:
    """Discounted return-to-go, reset at episode ends."""
    rewards = rewards.to(torch.float32)
    if episode_end is None:
        cont = torch.ones_like(rewards)
    else:
        cont = 1.0 - episode_end.to(torch.float32)
    return _reverse_scan(rewards, gamma * cont)


def nstep_returns(
    rewards: torch.Tensor,
    episode_end: torch.Tensor,
    target_q: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """n-step bootstrapped return.

    Args:
      rewards: ``[n, B]`` rewards at t..t+n-1 along the buffer's ``next``
        chain (slots past an episode end repeat the terminal index).
      episode_end: ``[n, B]`` done flags at t..t+n-1.
      target_q: ``[B, ...]`` bootstrapped value at t+n, already masked for
        true termination with :func:`value_mask`.
      gamma: discount.

    Returns the returns in the shape of ``target_q``.
    """
    n, bsz = rewards.shape[0], rewards.shape[1]
    tq = target_q.reshape(bsz, -1).to(torch.float32)
    rewards = rewards.to(torch.float32)
    acc = torch.zeros_like(tq)
    steps = torch.zeros(bsz, dtype=torch.int32, device=tq.device)
    for t in range(n - 1, -1, -1):
        ended = episode_end[t] > 0
        # the ended step itself contributes one reward, so the exponent restarts at 1
        steps = torch.where(ended, 1, steps + 1)
        acc = torch.where(ended[:, None], 0.0, acc)
        acc = rewards[t][:, None] + gamma * acc
    # gamma rounded to float32 on the device: a fill, not a host-to-device copy (which a CUDA graph cannot capture)
    gamma_pow = torch.pow(torch.full((), gamma, dtype=torch.float32, device=tq.device), steps.to(torch.float32))
    out = tq * gamma_pow[:, None] + acc
    return out.reshape(target_q.shape)
