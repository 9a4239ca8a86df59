"""Classic control tasks (port of ``tianshou_tpu/env/classic``)."""
