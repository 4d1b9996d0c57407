"""The readers of the program's spans and counters (``qa_bench/spans.py``):
card records put down to the innermost range that holds their launch call,
idle gaps named by the innermost covering range, every reader silent for a
program without spans, and the tiny traced cells reporting what the CPU can
read."""

import re
import types
from collections import Counter

import pytest

from qa_bench import harness, spans
from qa_bench import trace as tracing
from qa_bench.tests.test_qa_bench_runs import tiny_run

NEW = ("detector_busy_ms.rank", "vit_busy_ms.rank", "twin_busy_ms.rank", "scoring_busy_ms.rank",
       "heads_busy_ms.rank", "host_wait_ms.rank", "host_ms.views", "pad_pct.views")


def test_records_go_to_the_innermost_range_of_their_launch():
    # forward [0, 100) holds detector [10, 30) and scoring [40, 90), which
    # holds topk [50, 60); a second forward [200, 300)
    ranges = [(0, 100), (10, 30), (40, 90), (50, 60), (200, 300)]
    launch_at = {1: 5, 2: 12, 3: 30, 4: 55, 5: 60, 6: 95, 7: 150, 8: 250, 9: 45}
    records = [(c, "k", 0, 1) for c in (1, 2, 3, 4, 5, 6, 7, 8, 9)] + [(99, "lost call", 0, 1)]
    got = spans.attribute(ranges, launch_at, records)
    assert got == [0, 1, 1, 3, 3, 0, None, 4, 2, None]


def test_card_ms_are_unions_under_each_span():
    tree = [("forward", None), ("detector", 0), ("scoring", 0), ("scoring/topk", 2),
            ("scoring", 0)]
    recorded = [types.SimpleNamespace(name=n, parent=p) for n, p in tree]
    ranges = [("forward", 0, 1000), ("detector", 10, 100), ("scoring", 200, 500),
              ("scoring/topk", 300, 400), ("scoring", 600, 900)]
    launch_at = {1: 20, 2: 30, 3: 310, 4: 250, 5: 700, 6: 950, 7: 1500}
    # (correlation id, name, card start, card end): two overlapping
    # detector records, the first scoring span's records either side of
    # its top-k, one outside any stage, one outside the forward
    records = [(1, "a", 1000, 1100), (2, "b", 1050, 1200), (3, "c", 1300, 1310),
               (4, "d", 1250, 1300), (5, "e", 1400, 1450), (6, "f", 1500, 1510),
               (7, "g", 1600, 1640)]
    busy, lost, longest = spans.card_ms_by_span(recorded, ranges, launch_at, records)
    assert busy == {"forward": 200 + 60 + 50 + 10, "detector": 200, "scoring": 60 + 50,
                    "scoring/topk": 10}
    assert lost == pytest.approx(40 / 410) and longest == [("g", 40)]
    assert spans.card_ms_by_span(recorded[:4], ranges, launch_at, records) is None


def test_host_wait_is_the_stream_less_the_card():
    # two forwards in the profiled pass with 600 card ms, four in the span
    # pass with 1300 stream ms: 325 - 300 ms a forward
    found = spans.ProgramSpans({"forward": 600.0}, 2, {"forward": {"stream_ms": 1300.0}}, 4,
                               Counter())
    read = harness.load_reader("host_wait_ms.rank")
    assert read(types.SimpleNamespace(_program_spans=found)) == pytest.approx(25.0)
    off_card = spans.ProgramSpans({}, 0, {"forward": {"host_ms": 1.0}}, 4, Counter())
    assert read(types.SimpleNamespace(_program_spans=off_card)) is None


class _Host:
    def __init__(self, name, start, duration):
        self.n, self.s, self.d = name, start, duration

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


def test_gaps_are_named_by_the_innermost_covering_range():
    host = [_Host("bridgeqa/scene", 0, 1000), _Host("bridgeqa/images", 10, 900),
            _Host("bridgeqa/prepare", 20, 300), _Host("aten::copy_", 400, 20)]
    assert tracing._host_at(host, 50, 250) == "bridgeqa/prepare"
    assert tracing._host_at(host, 405, 415) == "aten::copy_"
    assert tracing._host_at(host, 500, 800) == "bridgeqa/images"


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_the_facility(monkeypatch, name):
    monkeypatch.setattr(spans, "facility", lambda: None)
    assert harness.load_reader(name)(types.SimpleNamespace()) is None


def test_tiny_traced_cells_report_the_span_metrics():
    """On the CPU the views cell reads its host work and padding; the rank
    cell records its span tree, but has no card records to attribute."""
    result, err = tiny_run("views", "--trace")
    metrics = result["metrics"]
    assert metrics["host_ms.views"]["value"] > 0
    frames, encoded = (int(re.search(rf"'views/{k}': (\d+)", err).group(1))
                       for k in ("frames", "frames_encoded"))
    assert frames < encoded and encoded % 4 == 0
    assert metrics["pad_pct.views"]["value"] == pytest.approx(100 * (1 - frames / encoded))
    result, err = tiny_run("rank", "--trace")
    for name in ("forward", "detector", "heads", "vit", "twin", "scoring", "scoring/topk"):
        assert re.search(rf"^span {re.escape(name)}: calls \d+", err, re.M), name
    assert not set(result["metrics"]) & set(NEW)
