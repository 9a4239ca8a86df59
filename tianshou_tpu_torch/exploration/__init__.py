"""Exploration noise (port of ``tianshou_tpu/exploration``)."""

from tianshou_tpu_torch.exploration.noise import GaussianNoise, OUNoise

__all__ = ["GaussianNoise", "OUNoise"]
