"""Data- and tensor-parallel programs over a torch device mesh (port of ``tianshou_tpu/parallel``)."""
