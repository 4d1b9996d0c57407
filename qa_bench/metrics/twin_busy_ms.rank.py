"""Card ms a rank forward in the twin encoder: the union of the card
records (kernels, copies, fills) whose launch calls lie inside the program's
``twin`` span or the spans under it, over the profiled pass of
qa_bench/spans.py. Unlike a stream span it holds no wait for the host."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("twin")
