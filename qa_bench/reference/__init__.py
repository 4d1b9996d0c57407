"""The plain PyTorch reference that decides ``correct``: float32 and eval
mode, no hand-written kernel, no fused path. It imports neither JAX nor
anything of ``bridgeqa_tpu`` or ``bridgeqa_tpu_torch``."""
