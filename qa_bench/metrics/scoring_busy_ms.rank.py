"""Card ms a rank forward in answer scoring: the union of the card records
(kernels, copies, fills) whose launch calls lie inside the program's two
``scoring`` spans (each decoder's first-token pass, top-k and gather,
scoring pass, and the scatter of its scores) or the spans under them, over
the profiled pass of qa_bench/spans.py. Unlike a stream span it holds no
wait for the host."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("scoring")
