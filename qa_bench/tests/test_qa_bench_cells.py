"""The harness finds a cell, its configuration, its traffic and its
per-layer readers by name, so a cell or a metric is added as files."""

import json
import shutil
from pathlib import Path

import pytest

from qa_bench import harness

CHECKOUT = Path(__file__).resolve().parents[2]


def copy_checkout(tmp_path: Path) -> Path:
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(CHECKOUT / "qa_bench" / sub, tmp_path / "qa_bench" / sub)
    return tmp_path


def test_added_cell_is_found_by_name(tmp_path):
    root = copy_checkout(tmp_path)
    traffic = json.loads((root / "qa_bench/workloads/rank-f32-b8.json").read_text())
    traffic["batch"] = 4
    (root / "qa_bench/workloads/rank-f32-b4.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "rank-f32-b4", "config": "bridgeqa-scanqa",
                               "traffic": "rank-f32-b4", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, cfg, found = harness.find_cell("rank-f32-b4", root)
    assert cell["traffic"] == "rank-f32-b4" and found["batch"] == 4
    assert cfg["num_answers"] == 4500


def test_added_metric_is_read_by_name(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "qa_bench/metrics/answers.rank.py").write_text(
        "def read(t):\n    return t.stage_per_batch('scoring')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "answers.rank", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "answer scoring",
                               "moves": "qa_per_s", "workloads": ["rank-f32-b8"]})
    names = [m["name"] for m in harness.per_layer_for(bench, "rank-f32-b8")]
    assert "answers.rank" in names and "vit_ms.views" not in names

    class Run:
        def stage_per_batch(self, stage):
            return {"scoring": 12.5}[stage]

    assert harness.load_reader("answers.rank", root / "qa_bench/metrics")(Run()) == 12.5


@pytest.mark.parametrize("own", [False, True])
def test_reader_falls_back_to_its_quantity(tmp_path, own):
    """``<quantity>.<kind>`` reads ``<quantity>.py`` unless a file of its own
    is there."""
    (tmp_path / "share.py").write_text("def read(t):\n    return 1.0\n")
    if own:
        (tmp_path / "share.views.py").write_text("def read(t):\n    return 2.0\n")
    assert harness.load_reader("share.views", tmp_path)(None) == (2.0 if own else 1.0)
    assert harness.load_reader("share.rank", tmp_path)(None) == 1.0


def test_every_listed_metric_has_a_reader():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for cell in bench["workloads"]:
        _, _, cfg, traffic = harness.find_cell(cell["name"])
        assert (CHECKOUT / "qa_bench/kinds" / f"{traffic['kind']}.py").exists()
        assert harness.per_layer_for(bench, cell["name"])
