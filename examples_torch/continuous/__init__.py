"""The port's ``examples/continuous`` scripts."""
