"""The training cell driven whole on the CPU at a tiny size (the port's plain path): the
reference agrees with the port's steps, the control in fp8 comes out not correct, and each
fault a training step can have comes out not correct."""
import json

import pytest
import torch

from benchmark import control, faults, harness

SEED = 2 ** 31 + 31337


def run(cell, trace=False):
    res = harness.run_cell(cell, SEED, 0.5, trace, "cpu", 0.0)
    assert json.loads(json.dumps(res)) == res  # the result line is plain JSON
    return res


def test_reference_agrees_with_the_training_step(tiny_cell):
    res = run(tiny_cell("b2_train_b4"))
    assert res["correct"], res["checks"]
    checks = {c["name"]: c["value"] for c in res["checks"]}
    # float32 on both sides, before Adam's first step
    assert res["notes"]["reported"]["grad_gap"] < 1e-4 and checks["bn_gap"] < 1e-4
    assert checks["half_batch"] < 1e-3  # the whole batch's statistics, far from any half's
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}


def test_control_in_fp8_is_not_correct(tiny_cell):
    cell = tiny_cell("b2_train_b4")
    for seed in (21, 22, 23):
        r = control.train_control_readings(cell, seed, torch.device("cpu"))
        assert not r["fp8"]["correct"], r["fp8"]["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_broken_training_step_is_not_correct(tiny_cell, fault):
    cell = tiny_cell("b2_train_b4")
    with faults.TRAIN[fault]():
        res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("drop", [(2, 3), (0, 2), (1, 3)])
def test_any_half_of_the_batch_left_out_is_seen(tiny_cell, drop):
    cell = tiny_cell("b2_train_b4")
    with faults.half_batch(drop):
        res = run(cell)
    half = {c["name"]: c for c in res["checks"]}["half_batch"]
    assert half["value"] > 100, half  # float32 on both sides: the kept half's, exactly
    weights = [round(w, 3) for w in half["image_weights"]]
    assert weights == [0.0 if i in drop else 2.0 for i in range(4)]
    assert not res["correct"]
