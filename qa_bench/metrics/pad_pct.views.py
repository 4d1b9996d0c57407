"""% of the frames the image tower encoded that are padding: 100 x (1 -
``views/frames`` / ``views/frames_encoded``), the program's counters over
the span pass of qa_bench/spans.py (the whole cycle of scenes)."""

from qa_bench import spans


def read(t):
    found = spans.of(t)
    if found is None or not found.counts["views/frames_encoded"]:
        return None
    encoded = found.counts["views/frames_encoded"]
    return 100.0 * (encoded - found.counts["views/frames"]) / encoded
