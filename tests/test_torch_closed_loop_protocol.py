"""The port's closed loop (`eval/closed_loop.py`) end to end at the JAX test's toy size.

The protocol of tests/test_closed_loop.py:14 (`--train_steps 2 --batch_size 2 --n_eval 2
--render_res 192 112`, a tiny physics-fit arm) through the port's `main` on the CPU: it
completes, writes the result, both checkpoints (which `BallDetector` / `TableDetector`
load) and the diagnostics, and its result holds the JAX package's key set. The parity of
each piece with JAX is in tests/test_torch_closed_loop.py.
"""
import json

import numpy as np
import torch

from upliftingtabletennis_torch.eval import closed_loop as CL
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)

# evaluate_pipeline's keys in the JAX package: always, with detections, with spin
# scores, and the physics-fit arm's counts and (from physfit_min_rallies on) metrics
ALWAYS = {"n_rallies", "n_rallies_skipped_short", "n_detected_frames",
          "ball_detection_px_mean", "ball_detection_px_median", "table_detection_px_mean",
          "table_detection_px_median", "table_px_per_keypoint", "calib_n_inliers_mean",
          "calib_reproj_px_mean", "calib_reproj_px_median", "pos3d_err_cm_mean",
          "pos3d_err_cm_median", "physfit_n_rallies", "physfit_n_calib_fail"}
PCK = {f"{n}_pck@{k}" for n in ("ball", "table") for k in (2, 5, 10, 20)}
SPIN = {"spin_accuracy", "spin_macro_f1"}
PHYSFIT_FEW = {"physfit_pos3d_err_cm_mean", "physfit_pos3d_err_cm_median",
               "physfit_spin_accuracy", "physfit_spin_macro_f1"}
PHYSFIT = PHYSFIT_FEW | {"physfit_gate_px", "physfit_max_spread_m",
                         "physfit_basin_spread_m_median", "physfit_n_seed_arbitrated",
                         "physfit_coverage", "physfit_n_converged",
                         "physfit_pos3d_err_cm_mean_converged",
                         "physfit_pos3d_err_cm_median_converged"}


def test_closed_loop_protocol_at_toy_size(tmp_path):
    res = CL.main(["--out", str(tmp_path), "--train_steps", "2", "--batch_size", "2",
                   "--n_eval", "2", "--render_res", "192", "112", "--physfit_starts", "2",
                   "--physfit_adam_steps", "3", "--physfit_lm_steps", "1", "--device", "cpu"])
    assert res["n_rallies"] == 2
    keys = set(res)
    assert ALWAYS <= keys <= ALWAYS | PCK | SPIN | PHYSFIT
    for group in (PCK, SPIN, PHYSFIT - PHYSFIT_FEW):
        assert not (group & keys) or group <= keys
    if res["physfit_n_rallies"] >= 8:
        assert PHYSFIT <= keys
    elif res["physfit_n_rallies"]:
        assert PHYSFIT_FEW <= keys
    for k in ("ball_detection_px_mean", "table_detection_px_mean", "pos3d_err_cm_mean"):
        assert res[k] is None or np.isfinite(res[k])
    assert json.load(open(tmp_path / "closed_loop_results.json")) == json.loads(
        json.dumps(res))
    assert (tmp_path / "rally_diag.json").exists()
    for task, det in (("ball", BallDetector), ("table", TableDetector)):
        state, ident, info = load_checkpoint(str(tmp_path / f"{task}_detector"))
        assert info["task"] == task and info["render_res"] == [192, 112]
        assert info["weights"] in ("raw", "ema") or info["weights"].startswith("best@")
        det(info["model"], str(tmp_path / f"{task}_detector"), 2, resolution=(192, 112),
            device="cpu")
