"""Multi-seed evaluation (port of ``tianshou_tpu/evaluation``)."""
