"""Card ms a rank forward in the heads: the union of the card records
(kernels, copies, fills) whose launch calls lie inside the program's
``heads`` spans (the object projection; the ensemble and the 2D/3D fusion;
the language and grounding heads), over the profiled pass of
qa_bench/spans.py."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.busy_ms("heads")
