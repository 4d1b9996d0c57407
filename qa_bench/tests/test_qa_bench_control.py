"""The control on the card: the reference computed one precision below, put
in the program's place, fails a cell's limits where the program holds them,
also with the detector kept in the cell's precision (only the layers after
it lowered). At the cells' own sizes ``python3 -m qa_bench.calibrate`` reads
both over a dozen seeds (PERF.md gives the readings); here at a size a test
run holds:

    python3 -m pytest -p no:cacheprovider -m cuda qa_bench/tests

Without a card, ``calibrate`` sets nothing: it exits with 2 and prints no
reading.
"""

import pytest
import torch

from qa_bench import calibrate, harness

SMALL = {"rank": {"batch": 2, "pool_batches": 1, "warmup": 1},
         "views": {"scene_frames": [40, 72]}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,exact", [("rank-f32-b8", ()), ("rank-f32-b8", ("detector",)),
                                        ("views-f32-b64", ())])
@pytest.mark.parametrize("seed", [2**31 + 3, 2**31 + 5, 2**31 + 7])
def test_control_fails_where_the_program_holds(card, cell, exact, seed):
    _, _, cfg, traffic = harness.find_cell(cell)
    traffic = {**traffic, **SMALL[traffic["kind"]]}
    found = calibrate.readings(cfg, traffic, seed, card, control=True, exact=exact)
    limits = traffic["limits"]
    assert all(found["program"][k] <= v for k, v in limits.items()), found
    assert any(found["control"][k] > v for k, v in limits.items()), found


def test_calibrate_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate.main(["--workload", "rank-f32-b8", "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""
