"""The port's ``examples/inverse`` scripts."""
