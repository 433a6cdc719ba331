"""The rest of the port's `eval/metrics.py` against the JAX package's: the mean pixel
distance and the mean streak distance over detections that are not the -100 sentinel
(10000 with none), and the visible/invisible accuracy of a 2-logit head.

Seeded inputs with sentinel rows, degenerate streaks (min = centre) and logit ties; f32
on both sides. Tolerance: 1e-6 relative (the same f32 operations; sums in another order),
and the sentinel returns and the accuracies exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.eval import metrics as JM
from upliftingtabletennis_torch.eval import metrics as M

RTOL = 1e-6


def _preds(rng, n, sentinel_rows):
    p = rng.uniform(0, 1920, (n, 3)).astype(np.float32)
    p[:, 2] = rng.integers(0, 2, n)
    p[sentinel_rows, rng.integers(0, 2, len(sentinel_rows))] = -100.0  # one coordinate out
    p[sentinel_rows[:1], :2] = -101.0
    return p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_distances_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 64
    preds = _preds(rng, n, rng.choice(n, 9, replace=False))
    gt = rng.uniform(0, 1920, (n, 2)).astype(np.float32)
    gt_min = gt + rng.normal(0, 8, (n, 2)).astype(np.float32)
    gt_max = gt + rng.normal(0, 8, (n, 2)).astype(np.float32)
    gt_min[:5] = gt[:5]  # degenerate segments
    got = M.average_distance(torch.from_numpy(preds), torch.from_numpy(gt))
    want = JM.average_distance(jnp.asarray(preds), jnp.asarray(gt))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    got = M.average_distance_to_streak(*map(torch.from_numpy, (preds, gt_min, gt, gt_max)))
    want = JM.average_distance_to_streak(*map(jnp.asarray, (preds, gt_min, gt, gt_max)))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # (N, K, 3) keypoints, as run_detection_eval passes the table
    kp = rng.uniform(-150, 1920, (8, 13, 3)).astype(np.float32)
    kp_gt = rng.uniform(0, 1920, (8, 13, 3)).astype(np.float32)
    np.testing.assert_allclose(float(M.average_distance(torch.from_numpy(kp),
                                                        torch.from_numpy(kp_gt))),
                               float(JM.average_distance(jnp.asarray(kp), jnp.asarray(kp_gt))),
                               rtol=RTOL)


def test_average_distances_return_10000_without_a_valid_detection():
    preds = np.full((4, 3), -100.0, np.float32)
    gt = np.zeros((4, 2), np.float32)
    for fn_t, fn_j, args in ((M.average_distance, JM.average_distance, (preds, gt)),
                             (M.average_distance_to_streak, JM.average_distance_to_streak,
                              (preds, gt, gt, gt))):
        got = float(fn_t(*map(torch.from_numpy, args)))
        assert got == float(fn_j(*map(jnp.asarray, args))) == 10000.0


@pytest.mark.parametrize("labels", ["mixed", "visible_only"])
def test_acc_visible_invisible_matches_jax(labels):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(40, 2)).astype(np.float32)
    logits[:6, 1] = logits[:6, 0]  # ties count as visible
    lab = rng.integers(0, 2, 40).astype(np.float32) if labels == "mixed" else np.ones(40,
                                                                                        np.float32)
    got = M.acc_visible_invisible(torch.from_numpy(logits), torch.from_numpy(lab))
    want = JM.acc_visible_invisible(jnp.asarray(logits), jnp.asarray(lab))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=RTOL, abs=0)
    if labels == "visible_only":
        assert float(got[1]) == 0.0
