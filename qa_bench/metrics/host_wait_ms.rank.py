"""Ms a rank forward in which the stream stood idle waiting for the host:
the program's ``forward`` span's stream ms (the span pass of
qa_bench/spans.py, without the profiler) minus the card ms of the records
attributed to ``forward`` (the profiled pass). The card ms varies by under
1% from run to run, so the reading follows the host's speed in the span
pass."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    if found is None:
        return None
    stream, card = found.stream_ms("forward"), found.busy_ms("forward")
    return None if stream is None or card is None else stream - card
