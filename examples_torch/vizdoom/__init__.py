"""The port's ``examples/vizdoom`` scripts."""
