"""Runtime key contracts (port of ``tianshou_tpu/data/types.py``; reserved
keys from reference buffer_base.py:41). The typed batch protocols of the JAX
module are static annotations only and are not ported."""

from __future__ import annotations

from tianshou_tpu_torch.data.batch import Batch

__all__ = ["ROLLOUT_KEYS", "TRANSITION_EXAMPLE_KEYS", "validate_keys"]

ROLLOUT_KEYS = ("obs", "act", "rew", "terminated", "truncated", "done", "obs_next")

# keys a transition example must provide to allocate buffer storage
# ("done" and "obs_next" are derived/optional at init time)
TRANSITION_EXAMPLE_KEYS = ("obs", "act", "rew", "terminated", "truncated")


def validate_keys(batch: Batch, required: tuple[str, ...]) -> None:
    """Raise KeyError if ``batch`` lacks any of ``required`` top-level keys."""
    missing = [k for k in required if k not in batch]
    if missing:
        raise KeyError(f"batch is missing required keys {missing}; has {list(batch.keys())}")
