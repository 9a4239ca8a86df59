"""The port's ``examples/discrete`` scripts."""
