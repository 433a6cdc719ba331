"""The port's dual-model filters against the JAX package's, on seeded detections.

The JAX filters cluster with sklearn's DBSCAN where it is installed; the port
always uses its numpy DBSCAN. Same inputs, results equal to float precision.
"""
import numpy as np
import pytest

from upliftingtabletennis_tpu.pipeline import filters as jax_filters
from upliftingtabletennis_torch.pipeline import filters
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector


def _ball_preds(seed, T=60):
    rng = np.random.default_rng(seed)
    p1 = np.column_stack([rng.uniform(0, 1920, T), rng.uniform(0, 1080, T),
                          rng.integers(0, 2, T)]).astype(np.float32)
    p2 = p1.copy()
    p2[:, :2] += rng.normal(0, 15, (T, 2))  # some within 20 px, some not
    p2[:, 2] = np.where(rng.uniform(size=T) < 0.8, p1[:, 2], 1 - p1[:, 2])
    return p1, p2


@pytest.mark.parametrize("seed", [0, 1])
def test_ball_filter_matches_jax(seed):
    p1, p2 = _ball_preds(seed)
    got = BallDetector.filter_trajectory(p1, p2, 30.0)
    want = jax_filters.filter_trajectory_ball(p1, p2, 30.0)
    assert 0 < len(got[1]) < len(p1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _table_preds(seed, T=40):
    """Per keypoint a different situation: a tight cluster with outliers, two clusters,
    scattered points (all noise), fewer than 3 agreeing frames, never visible."""
    rng = np.random.default_rng(seed)
    p1 = np.zeros((T, 13, 3), np.float32)
    centres = rng.uniform([100, 100], [1800, 1000], (13, 2))
    for n in range(13):
        kind = n % 5
        if kind == 0:
            pts = centres[n] + rng.normal(0, 2, (T, 2))
            pts[::7] += rng.uniform(-300, 300, (len(pts[::7]), 2))
        elif kind == 1:
            pts = centres[n] + rng.normal(0, 2, (T, 2))
            pts[: T // 3] += 60.0
        elif kind == 2:
            pts = centres[n] + rng.uniform(-500, 500, (T, 2))
        else:
            pts = centres[n] + rng.normal(0, 2, (T, 2))
        p1[:, n, :2] = pts
        p1[:, n, 2] = 1
        if kind == 3:
            p1[2:, n, 2] = 0  # only 2 visible frames
        if kind == 4:
            p1[:, n, 2] = 0
    p2 = p1.copy()
    p2[..., :2] += rng.normal(0, 3, (T, 13, 2))
    return p1, p2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_filter_matches_jax(seed):
    p1, p2 = _table_preds(seed)
    got = TableDetector.filter_trajectory(p1, p2)
    want = jax_filters.filter_trajectory_table(p1, p2)
    assert got.shape == (13, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert (got[3::5, 2] == 0).all() and (got[4::5, 2] == 0).all() and (got[0::5, 2] == 1).all()


def test_dbscan_cluster_cases_match_jax():
    rng = np.random.default_rng(3)
    noise = rng.uniform(0, 1000, (6, 2))  # every point is noise: the mean
    two = rng.normal(0, 1, (2, 2))  # fewer than min_samples: the mean
    big_small = np.concatenate([rng.normal(0, 2, (7, 2)), rng.normal(50, 2, (4, 2))])
    for pts in (noise, two, big_small, np.zeros((0, 2))):
        got = filters._dbscan_largest_cluster(pts)
        want = jax_filters._dbscan_largest_cluster(pts)
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12)


def test_port_filters_do_not_import_sklearn():
    import inspect
    import re

    assert not re.search(r"^\s*(import|from)\s+sklearn", inspect.getsource(filters), re.M)
