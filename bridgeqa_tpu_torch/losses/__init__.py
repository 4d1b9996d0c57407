"""Losses of the port: VoteNet detection, grounding, language, answer."""

from bridgeqa_tpu_torch.losses.detection import get_loss

__all__ = ["get_loss"]
