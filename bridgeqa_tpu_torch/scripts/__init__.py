"""The port's drivers, run as ``python -m bridgeqa_tpu_torch.scripts.<name>``:
``train``, ``predict``, ``eval`` and ``score`` (``common`` holds what they
share)."""
