"""On the card: a short run of each cell through the whole harness comes
out correct, with the device named and the traced metrics present. Skips
without a card; on an H100 run it with
``python -m pytest portbench/tests -m cuda -q -p no:cacheprovider``."""

import pytest

from portbench import run, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_short_traced_run_is_correct_on_the_card(card, cell):
    live = spec.find(cell).traffic["entry"] == "live"
    res = run.run_cell(cell, 2**31 + 21, 10.0 if live else 3.0, True, device=card)  # live: 20 frames for 16 anchors
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"], "every cell reports a per-layer metric"
    assert not res["forbidden"]
