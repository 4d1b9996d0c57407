"""Host ms a scene of view selection's own work: the self time of the
program's ``prepare`` (numpy casts, padding, contiguous copies), ``upload``
(the pageable copies to the card), ``tokenize`` and ``rank`` spans, over
the span pass of qa_bench/spans.py (the whole cycle of scenes)."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    return None if found is None else found.self_host_ms(("prepare", "upload", "tokenize",
                                                           "rank"))
