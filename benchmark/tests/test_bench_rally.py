"""A rally cell driven whole on the CPU at a tiny size (the port's plain path): the reference
agrees with the port, the control in fp8 comes out not correct, and a run whose timed path
is broken underneath comes out not correct."""
import json

import numpy as np
import pytest
import torch

from benchmark import control, faults, harness

SEED = 2 ** 31 + 4242


def run(cell, trace=False):
    res = harness.run_cell(cell, SEED, 0.5, trace, "cpu", 0.0)
    assert json.loads(json.dumps(res)) == res  # the result line is plain JSON
    return res


@pytest.mark.parametrize("name", ["ensemble_i420_full", "ensemble_rgb_stride16"])
def test_reference_agrees_with_the_port(tiny_cell, name):
    res = run(tiny_cell(name))
    checks = {c["name"]: c for c in res["checks"]}
    assert res["correct"], res["checks"]
    assert checks["peak_gap"]["value"] <= 1e-4 and checks["filter_mismatch"]["value"] == 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_traced_run_reports_the_per_layer_metrics(tiny_cell):
    res = run(tiny_cell("ensemble_i420_full"), trace=True)
    assert res["correct"]
    # the CPU has no device trace: only the counted work reads anything
    assert set(res["metrics"]) <= {"mfu.rally", "launches_per_frame.rally"}
    assert "window_s" in res["device"] and "breakdown" in res
    assert list(res)[-1] == "checks"


def test_control_in_fp8_is_not_correct(tiny_cell):
    cell = tiny_cell("ensemble_i420_full")
    for seed in (11, 12, 13):
        r = control.control_readings(cell, seed, torch.device("cpu"), n_rallies=4)
        assert not r["correct"], r["checks"]
        assert {c["name"] for c in r["checks"]} == {"peak_gap", "vis_mismatch", "uplift_err"}


@pytest.mark.parametrize("fault", sorted(faults.RALLY))
def test_broken_timed_path_is_not_correct(tiny_cell, fault):
    cell = tiny_cell("ensemble_i420_full")
    with faults.RALLY[fault]():
        res = run(cell)
    assert not res["correct"], res["checks"]


def test_every_frame_of_a_rally_is_judged_from_the_pool(tiny_cell):
    from benchmark.checks import rally as rc
    from benchmark.entries.rally import Rally

    done = [Rally(0, 9, 0.0, peaks=()), Rally(3, 14, 0.0, peaks=()), Rally(5, 20, 0.0, peaks=())]
    s = rc.draw_samples(SEED, done, 12, 4, 8)
    assert len(s) == 12 and {i for i, _, _ in s} == {0, 1, 2}
    for i, T in enumerate((9, 14, 20)):  # each rally's first and last piece, first and last row
        mine = [(t, j) for k, t, j in s if k == i]
        assert mine[0][0] < 8 and mine[0][1] == 0
        assert mine[1][0] >= (T - 1) // 8 * 8 and mine[1][1] == len(range(0, T, 4)) - 1
    assert all(0 <= t < done[i].length and 0 <= j < len(range(0, done[i].length, 4))
               for i, t, j in s)
    assert rc.draw_samples(SEED, done, 12, 4, 8) == s
    assert len(rc.draw_samples(SEED, done, 2, 4, 8)) == 6  # never fewer than two a rally
    assert np.isfinite(rc.upload_target(tiny_cell("ensemble_i420_full").config)).all()
