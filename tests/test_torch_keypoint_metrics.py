"""The port's `eval/keypoint_metrics.py` against the JAX package's.

tests/test_keypoint_metrics.py holds the JAX module against the mmpose functions of the
reference, which are absent here; this file holds the port against the JAX module on
seeded inputs that reach every quirk: rows of `normalize` with a zero component (invalid
as a whole) and with negative entries (clamped to 1e6), keypoints with no valid sample
(-1, left out of the average and the count), heatmap maxima that tie (the first in
argmax order wins) and that are not positive (-1).

Tolerance: the argmax predictions, the -1 entries, the masks' counts and the PCK values
exactly (counts over the same valid sets); the distances, AUC, NME and EPE within 1e-6
relative (the same f32 operations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.eval import keypoint_metrics as JK
from upliftingtabletennis_torch.eval import keypoint_metrics as K

RTOL = 1e-6


def _case(seed, N=12, Kp=7):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 64, (N, Kp, 2)).astype(np.float32)
    pred = gt + rng.normal(0, 4, (N, Kp, 2)).astype(np.float32)
    mask = rng.uniform(size=(N, Kp)) > 0.3
    mask[:, 0] = False  # a keypoint with no valid sample
    norm = rng.uniform(20, 80, (N, 2)).astype(np.float32)
    norm[1, 0] = 0.0  # a row wholly invalidated
    norm[2, 1] = -3.0  # clamped to 1e6
    return pred, gt, mask, norm


def _eq(got, want, rtol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_calc_distances_and_distance_acc_match_jax(seed):
    pred, gt, mask, norm = _case(seed)
    d = K._calc_distances(pred, gt, mask, norm)
    dj = JK._calc_distances(pred, gt, mask, norm)
    _eq(d == -1, np.asarray(dj) == -1)  # the sentinel exactly
    _eq(d, dj, RTOL)
    for thr in (0.05, 0.1, 0.5):
        _eq(K._distance_acc(d, thr), JK._distance_acc(dj, thr))


@pytest.mark.parametrize("seed", [0, 1])
def test_pck_auc_nme_epe_match_jax(seed):
    pred, gt, mask, norm = _case(seed)
    for thr in (0.05, 0.2):
        got = K.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        want = JK.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        _eq(got[0], want[0])
        assert float(got[0][0]) == -1.0  # no valid sample
        _eq(got[1], want[1], RTOL)
        assert int(got[2]) == int(want[2])
    for normalize in (30.0, 64.0):
        _eq(K.keypoint_auc(pred, gt, mask, normalize), JK.keypoint_auc(pred, gt, mask, normalize),
            RTOL)
    _eq(K.keypoint_nme(pred, gt, mask, norm), JK.keypoint_nme(pred, gt, mask, norm), RTOL)
    _eq(K.keypoint_epe(pred, gt, mask), JK.keypoint_epe(pred, gt, mask), RTOL)


def _heatmaps(seed, shape):
    rng = np.random.default_rng(seed)
    hm = rng.integers(-3, 4, shape).astype(np.float32)  # integer values: many ties
    hm[0, 0] = -1.0  # the maximum is not positive: -1
    hm[0, 1] = 0.0
    return hm


def test_get_max_preds_match_jax_with_ties():
    hm = _heatmaps(4, (3, 5, 6, 7))
    got, got_v = K.get_max_preds(hm)
    want, want_v = JK.get_max_preds(hm)
    _eq(got, want)
    _eq(got_v, want_v)
    assert (got[0, :2] == -1).all()
    hm3 = _heatmaps(5, (2, 4, 3, 5, 6))
    got, got_v = K.get_max_preds_3d(hm3)
    want, want_v = JK.get_max_preds_3d(hm3)
    _eq(got, want)
    _eq(got_v, want_v)


def test_pose_pck_accuracy_matches_jax():
    rng = np.random.default_rng(6)
    out = rng.normal(size=(4, 5, 16, 12)).astype(np.float32)
    tgt = rng.normal(size=(4, 5, 16, 12)).astype(np.float32)
    mask = rng.uniform(size=(4, 5)) > 0.2
    for normalize in (None, np.full((4, 2), 8.0, np.float32)):
        got = K.pose_pck_accuracy(out, tgt, mask, 0.3, normalize)
        want = JK.pose_pck_accuracy(jnp.asarray(out), jnp.asarray(tgt), mask, 0.3, normalize)
        _eq(got[0], want[0])
        _eq(got[1], want[1], RTOL)
        assert int(got[2]) == int(want[2])
    assert K.pose_pck_accuracy(np.zeros((2, 0, 4, 4), np.float32), None, None) == (None, 0, 0)
