"""BridgeQA in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of ``bridgeqa_tpu`` (JAX on a TPU), kept beside it; the JAX package
is the reference the tests hold it to. Layout mirrors the JAX package:
``ops/`` (point ops; ``csrc/`` holds their CUDA kernels), ``models/``,
``geometry/``, plus ``convert.py`` to load the JAX package's weights. It
imports no JAX.
"""
