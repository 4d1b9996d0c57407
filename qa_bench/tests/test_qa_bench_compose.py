"""A tiny compose cell run end to end through the harness in a fresh
process: its last line, its metrics and its check, no module of JAX or the
JAX package loaded; its program spans recorded in the traced run; and
``correct`` false for each fault the timed path can have (one routed
expert's output dropped, a row of the latent cache corrupted, a row's
prompt shortened). On the card (marked ``cuda``), the traced run leaves no
more than 1% of the card time to no span, and at the cell's own size the
sound program is correct and each fault is not."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qa_bench import harness

CHECKOUT = Path(__file__).resolve().parents[2]
SPANS = ("compose", "lm/prefill", "lm/decode", "lm/moe", "lm/attention", "lm/dense", "lm/head")


def tiny_run(*args) -> tuple[dict, str]:
    env = {**os.environ, "PYTHONPATH": str(CHECKOUT)}
    proc = subprocess.run([sys.executable, "-m", "qa_bench.tests.tiny_compose", *args],
                          cwd=CHECKOUT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_compose_cell_end_to_end(traced):
    result, err = tiny_run(*(["--trace"] if traced else []))
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    bench, cell, _, traffic = harness.find_cell("compose-bf16-b256")
    names = set(result["metrics"])
    if traced:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell["name"])}
        # the CPU run has no device trace: the span readers read, the others stay silent
        assert names - {"setup_s"} <= allowed and "host_wait_ms.compose" not in names
        for name in SPANS:
            assert re.search(rf"^span {re.escape(name)}: calls [1-9]", err, re.M), name
        assert re.search(r"'lm/tokens_prefilled': [1-9]", err)
        assert re.search(r"'lm/tokens_decoded': [1-9]", err)
        assert re.search(r"'moe/rows_routed': [1-9]", err)
    else:
        assert names == {"qa_per_s", "batch_ms_p90", "setup_s"}
    assert set(result["checks"]) == set(traffic["limits"])
    assert err.strip().splitlines()[-1] == "forbidden modules: []"


@pytest.mark.parametrize("fault", ["expert", "cache", "prompt"])
def test_broken_compose_path_is_not_correct(fault):
    result, _ = tiny_run("--fault", fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.cuda
def test_compose_spans_cover_the_card_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, err = tiny_run("--trace", "--device", "cuda")
    assert result["correct"] is True
    share = re.search(r"unattributed ([0-9.]+)% of the card time", err)
    assert share and float(share.group(1)) <= 1.0, share
    for name in ("prefill_busy_ms.compose", "decode_busy_ms.compose", "moe_busy_ms.compose",
                 "mla_busy_ms.compose", "moe_roofline.compose"):
        assert name in result["metrics"], name


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "expert", "cache", "prompt"])
def test_compose_check_at_full_size(fault):
    """The check at the cell's own size in bf16, where the rounding of 27
    layers is far above the tiny f32 cell's: the sound program holds every
    limit, and each fault breaks one (PERF.md, section 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = tiny_run("--full", "--device", "cuda", *(["--fault", fault] if fault else []))
    broken = [name for name, c in result["checks"].items() if c["value"] > c["limit"]]
    assert result["correct"] is (fault is None) and bool(broken) is (fault is not None), broken
