"""tianshou_tpu_torch: the PyTorch/CUDA port of ``tianshou_tpu``.

It keeps the JAX package's module layout and names, so that every module has
an obvious counterpart, and uses PyTorch idiom inside: ``nn.Module``s, plain
functions on tensors, an explicit ``device`` and explicit
``torch.Generator``s. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Kernels that the JAX package wrote in Pallas for the TPU
are hand-written CUDA kernels here (``ops/kernels``).
"""

__version__ = "0.1.0"
