"""Card ms a composition batch in the decode loop: the union of the card
records whose launch calls lie inside the program's ``lm/decode`` span (every
step's layers over the latent cache, the head and the argmax), over the
profiled pass of qa_bench/spans.py."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("lm/decode")
