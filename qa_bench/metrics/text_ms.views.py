"""Stream milliseconds per scene in the text tower (encode_texts), between
CUDA events at its forward hooks."""


def read(t):
    return t.stage_per_batch("text")
