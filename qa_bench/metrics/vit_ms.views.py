"""Stream milliseconds per encode_images call of view selection (one image
batch), between CUDA events at the image encoder's forward hooks."""


def read(t):
    return t.stage_per_call("vit")
