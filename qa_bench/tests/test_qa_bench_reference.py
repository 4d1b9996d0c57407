"""The reference against the port at tiny sizes on the CPU, through the
harness's sessions: the module path, and the fused paths run through the
kernels' plain versions ("force"), which compute what the card's kernels
compute. The detector runs alike on both sides and agrees bitwise."""

import pytest
import torch

from qa_bench.kinds import rank, views
from qa_bench.tests import tiny

SEED = 2**31 + 101


@pytest.fixture(params=["off", "force"])
def fused(request, monkeypatch):
    from bridgeqa_tpu_torch.ops import vit_block

    monkeypatch.setattr(vit_block, "FUSED_MODE", request.param)
    return request.param


def test_rank_against_reference(fused):
    cfg = tiny.rank_config()
    cfg["blip"]["med"]["fused_scoring"] = fused
    traffic = tiny.rank_traffic()
    session = rank.Session(cfg, traffic, SEED, torch.device("cpu"))
    session.batch(0, 0)
    session.release()
    found = session.numbers()[0]
    assert found["detector_gap"] == 0.0
    assert found["topk_miss"] == 0.0 and found["top1_miss"] == 0.0
    for name, limit in traffic["limits"].items():
        assert found[name] <= limit / 10, (name, found[name])


def test_views_against_reference(fused):
    cfg, traffic = tiny.views_config(), tiny.views_traffic()
    session = views.Session(cfg, traffic, SEED, torch.device("cpu"))
    session.batch(1, 0)
    session.release()
    found = session.numbers()[0]
    assert found["order_miss"] == 0.0
    for name, limit in traffic["limits"].items():
        assert found[name] <= limit / 10, (name, found[name])


def test_control_keeps_the_detector_exact():
    """With ``exact=("detector",)`` the control lowers only what follows the
    detector: its outputs agree bitwise, the scores do not."""
    cfg, traffic = tiny.rank_config(), {**tiny.rank_traffic(), "control": "fp8"}
    session = rank.Session(cfg, traffic, SEED, torch.device("cpu"))
    session.batch(0, 0)
    session.release()
    whole = session.numbers(control=True)[0]
    after = session.numbers(control=True, exact=("detector",))[0]
    assert whole["detector_gap"] > 0.0 and after["detector_gap"] == 0.0
    assert after["score_gap"] > 0.0 and after["ground_gap"] > 0.0
