"""Ms a composition batch in which the stream stood idle in the decode loop
waiting for the host: the program's ``lm/decode`` span's stream ms (the span
pass of qa_bench/spans.py, without the profiler) minus the card ms of the
records attributed to it (the profiled pass). The decode loop issues some
thousand launches a step; where the host issues them more slowly than the
card runs them, this grows."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    if found is None:
        return None
    stream, card = found.stream_ms("lm/decode"), found.busy_ms("lm/decode")
    return None if stream is None or card is None else stream - card
