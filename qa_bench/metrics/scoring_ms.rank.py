"""Stream milliseconds per rank forward in both decoders (the first-token
and the scoring pass of each), between CUDA events at their modules'
forward hooks. Where the host issues the work more slowly than the card
runs it, the span holds the card's wait for the host."""


def read(t):
    return t.stage_per_batch("scoring")
