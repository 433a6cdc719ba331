"""The dual-model filters and the uplifting model's input, in numpy, as the reference
pipeline defines them: a ball frame is kept where both detectors see the ball and agree
within 20 px; a table keypoint is the centroid of the largest DBSCAN cluster (eps 10 px,
3 samples) of the frames where both detectors see it and agree within 10 px; the uplifting
input is the filtered track over (width, height), its first `seq_len` steps, zero-padded."""
from __future__ import annotations

from collections import Counter

import numpy as np


def ball(pred1, pred2, fps, agree_px):
    diff = np.linalg.norm(pred1[:, :2] - pred2[:, :2], axis=1)
    ok = (diff <= agree_px) & (pred1[:, 2] == 1) & (pred2[:, 2] == 1)
    idx = np.nonzero(ok)[0]
    return pred1[idx, :2].astype(np.float64), idx, idx / float(fps)


def _dbscan_labels(points, eps, min_samples):
    n = len(points)
    nb = np.linalg.norm(points[:, None] - points[None, :], axis=-1) <= eps
    core = nb.sum(1) >= min_samples
    labels = -np.ones(n, int)
    cur = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cur
        stack = [i]
        while stack:
            j = stack.pop()
            for k in np.nonzero(nb[j])[0]:
                if labels[k] == -1:
                    labels[k] = cur
                    if core[k]:
                        stack.append(k)
        cur += 1
    return labels


def _largest_cluster(points, eps, min_samples):
    if len(points) < min_samples:
        return np.mean(points, axis=0)
    labels = _dbscan_labels(points, eps, min_samples)
    valid = labels[labels != -1]
    if valid.size == 0:
        return np.mean(points, axis=0)
    biggest = Counter(valid.tolist()).most_common(1)[0][0]
    return np.mean(points[labels == biggest], axis=0)


def table(pred1, pred2, agree_px, min_samples):
    T, N, _ = pred1.shape
    out = np.zeros((N, 3))
    for n in range(N):
        both = (pred1[:, n, 2] == 1) & (pred2[:, n, 2] == 1)
        dist = np.linalg.norm(pred1[:, n, :2] - pred2[:, n, :2], axis=1)
        pts = pred1[both & (dist < agree_px), n, :2]
        if len(pts) < min_samples:
            out[n] = (-1, -1, 0)
            continue
        c = _largest_cluster(pts, agree_px, min_samples)
        out[n] = (c[0], c[1], 1)
    return out


def uplifting_inputs(ball_xy, table_kp, times, width, height, seq_len):
    b = np.asarray(ball_xy, np.float32) / np.asarray([width, height], np.float32)
    t = np.asarray(table_kp, np.float32).copy()
    t[:, 0] /= width
    t[:, 1] /= height
    n = min(len(b), seq_len)
    ob = np.zeros((1, seq_len, 2), np.float32)
    ot = np.zeros((1, seq_len), np.float32)
    m = np.zeros((1, seq_len), np.float32)
    ob[0, :n], ot[0, :n], m[0, :n] = b[:n], np.asarray(times, np.float32)[:n], 1.0
    return ob, t[None], ot, m
