"""Dual-model trajectory filters, on the host in numpy.

The port's copy of `upliftingtabletennis_tpu/pipeline/filters.py`
(`filter_trajectory_ball`, `filter_trajectory_table`,
`_dbscan_largest_cluster`). The data is tiny (at most hundreds of points per
rally), so it stays host code:

* ball: keep a frame iff both models report the ball visible and their
  positions agree within 20 px; return (positions, valid indices, times =
  t / fps);
* table: per keypoint, the frames where both models see it and agree within
  10 px; with 3 or more, DBSCAN(eps=10, min_samples=3) and the centroid of the
  largest cluster, the mean when every point is noise; else invisible;
* `uplifting_inputs`: normalise and pad the filtered detections to the uplifting
  model's input (`SEQUENCE_LEN` = 50 steps).

Clustering uses the JAX package's own numpy DBSCAN (`_density_labels`), never
sklearn: the card's machine has none.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np

BALL_AGREEMENT_PX = 20.0
TABLE_AGREEMENT_PX = 10.0
VISIBLE = 1
INVISIBLE = 0
SEQUENCE_LEN = 50

__all__ = ["filter_trajectory_ball", "filter_trajectory_table", "uplifting_inputs", "VISIBLE",
           "INVISIBLE", "SEQUENCE_LEN"]


def filter_trajectory_ball(pred1: np.ndarray, pred2: np.ndarray, fps: float):
    """(T, 3) x2 -> (positions (T', 2), valid_indices (T',), times (T',))."""
    diff = np.linalg.norm(pred1[:, :2] - pred2[:, :2], axis=1)
    ok = (diff <= BALL_AGREEMENT_PX) & (pred1[:, 2] == VISIBLE) & (pred2[:, 2] == VISIBLE)
    idx = np.nonzero(ok)[0]
    return pred1[idx, :2].astype(np.float64), idx, idx / float(fps)


def _density_labels(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels (-1 for noise) by pairwise-distance core-point expansion."""
    n = len(points)
    d = np.linalg.norm(points[:, None] - points[None, :], axis=-1)
    neighbors = d <= eps
    core = neighbors.sum(1) >= min_samples
    labels = -np.ones(n, int)
    cur = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = [i]
        labels[i] = cur
        while stack:
            j = stack.pop()
            for k in np.nonzero(neighbors[j])[0]:
                if labels[k] == -1:
                    labels[k] = cur
                    if core[k]:
                        stack.append(k)
        cur += 1
    return labels


def _dbscan_largest_cluster(points: np.ndarray, eps=10.0, min_samples=3) -> Optional[np.ndarray]:
    """Centroid of the largest DBSCAN cluster; the mean when there are fewer points than
    min_samples or every point is noise; None for no points."""
    if points.shape[0] == 0:
        return None
    if points.shape[0] < min_samples:
        return np.mean(points, axis=0)
    labels = _density_labels(points, eps, min_samples)
    valid = labels[labels != -1]
    if valid.size == 0:
        return np.mean(points, axis=0)
    biggest = Counter(valid.tolist()).most_common(1)[0][0]
    return np.mean(points[labels == biggest], axis=0)


def filter_trajectory_table(pred1: np.ndarray, pred2: np.ndarray) -> np.ndarray:
    """(T, 13, 3) x2 -> (13, 3) fused keypoints: x, y, visibility (-1, -1, 0 if unseen)."""
    T, N, _ = pred1.shape
    out = np.zeros((N, 3))
    for n in range(N):
        both = (pred1[:, n, 2] == VISIBLE) & (pred2[:, n, 2] == VISIBLE)
        dist = np.linalg.norm(pred1[:, n, :2] - pred2[:, n, :2], axis=1)
        pts = pred1[both & (dist < TABLE_AGREEMENT_PX), n, :2]
        if pts.shape[0] < 3:
            out[n] = (-1, -1, INVISIBLE)
            continue
        c = _dbscan_largest_cluster(pts, eps=TABLE_AGREEMENT_PX, min_samples=3)
        out[n] = (c[0], c[1], VISIBLE) if c is not None else (-1, -1, INVISIBLE)
    return out


def uplifting_inputs(ball_coords, table_coords, times, width, height, seq_len=SEQUENCE_LEN):
    """Pixel detections -> the uplifting model's inputs: coordinates divided by (width,
    height), the first seq_len steps, zero-padded.

    Returns (ball (1, L, 2), table (1, 13, 3), times (1, L), mask (1, L)), float32."""
    ball = np.asarray(ball_coords, np.float32) / np.asarray([width, height], np.float32)
    table = np.asarray(table_coords, np.float32).copy()
    table[:, 0] /= width
    table[:, 1] /= height
    n = min(ball.shape[0], seq_len)
    out_ball = np.zeros((1, seq_len, 2), np.float32)
    out_times = np.zeros((1, seq_len), np.float32)
    mask = np.zeros((1, seq_len), np.float32)
    out_ball[0, :n] = ball[:n]
    out_times[0, :n] = np.asarray(times, np.float32)[:n]
    mask[0, :n] = 1.0
    return out_ball, table[None], out_times, mask
