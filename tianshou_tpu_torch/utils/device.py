"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when no device or a CUDA device was asked for and no GPU is
    present: the port never moves to the CPU unless the caller asks for it.
    """
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
