"""Stream milliseconds per rank forward in the image encoder (the ViT), between CUDA
events at its modules' forward hooks. Where the host issues the work more
slowly than the card runs it, the span holds the card's wait for the host."""


def read(t):
    return t.stage_per_batch("vit")
