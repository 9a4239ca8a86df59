"""The port's ``examples/benchmark`` scripts."""
