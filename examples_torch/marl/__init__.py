"""The port's ``examples/marl`` scripts."""
