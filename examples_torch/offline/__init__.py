"""The port's ``examples/offline`` scripts."""
