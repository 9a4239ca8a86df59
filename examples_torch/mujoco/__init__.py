"""The port's ``examples/mujoco`` scripts."""
