"""A tiny cell of each traffic kind, run end to end through the harness on
the CPU in a fresh process: its last line, its metrics, its check, and no
module of JAX or the JAX package loaded; and with the timed path broken
underneath, ``correct`` false."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from qa_bench import harness

CHECKOUT = Path(__file__).resolve().parents[2]
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


def tiny_run(*args) -> tuple[dict, str]:
    env = {**os.environ, "PYTHONPATH": str(CHECKOUT)}
    proc = subprocess.run([sys.executable, "-m", "qa_bench.tests.tiny_cell", *args],
                          cwd=CHECKOUT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("kind", ["rank", "views"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_end_to_end(kind, traced):
    result, err = tiny_run(kind, *(["--trace"] if traced else []))
    assert REQUIRED <= set(result) and set(result) - REQUIRED <= {"checks", "breakdown"}
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    bench, cell, _, _ = harness.find_cell({"rank": "rank-f32-b8", "views": "views-f32-b64"}[kind])
    names = set(result["metrics"])
    assert "setup_s" in names
    if traced:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell["name"])}
        # the CPU run has no device trace: the span readers read, the others stay silent
        assert names - {"setup_s"} <= allowed and names - {"setup_s"}
    else:
        e2e = {m["name"] for m in bench["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
        assert names == e2e
    assert set(result["checks"]) == set(harness.load_json(
        harness.ROOT / "workloads" / f"{cell['traffic']}.json")["limits"])
    assert err.strip().splitlines()[-1] == "forbidden modules: []"


@pytest.mark.parametrize("kind", ["rank", "views"])
@pytest.mark.parametrize("fault", ["answer", "half"])
def test_broken_timed_path_is_not_correct(kind, fault):
    result, _ = tiny_run(kind, "--fault", fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
