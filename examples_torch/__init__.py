"""Runnable example scripts of the PyTorch port, one per script of
``examples/``, at the same path under this package
(``examples_torch/<dir>/<script>.py``). See ``README.md``."""
