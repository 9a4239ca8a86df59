"""The port's ``examples/atari`` scripts."""
