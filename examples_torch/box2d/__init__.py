"""The port's ``examples/box2d`` scripts."""
