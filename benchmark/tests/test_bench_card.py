"""The benchmark's path on the card at a tiny size: each cell runs end to end through the
port's kernels and hands back every check. Marked `cuda`; skips without a card.

    python -m pytest benchmark/tests -q -m cuda
"""
import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.parametrize("name", ["ensemble_i420_full", "ensemble_rgb_stride16", "b2_train_b4"])
def test_cell_runs_on_the_card(tiny_cell, card, name):
    res = harness.run_cell(tiny_cell(name), 2 ** 31 + 7, 1.0, True, card, 0.0)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all({"name", "value", "limit"} <= set(c) for c in res["checks"])
