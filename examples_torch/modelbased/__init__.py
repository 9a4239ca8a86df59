"""The port's ``examples/modelbased`` scripts."""
