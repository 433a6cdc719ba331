"""Eval-time robustness transforms of the uplifting model, numpy.

Port of `upliftingtabletennis_tpu/eval/robustness.py` (its own copy; the port imports
nothing of the JAX package): Identity, HalfFPS (every second valid detection dropped),
DropBall, DropTable, Drop and Combine over batched padded dicts {'r_img' (B, T, 2)
normalised, 'table_img' (B, 13, 3), 'mask' (B, T), 'times' (B, T)}. Dropping compacts the
survivors to the left, as the reference's sequential copy loops do. The random drops come
from `np.random.default_rng(seed)`, the same draws as the JAX package's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Identity", "HalfFPS", "DropBall", "DropTable", "Drop", "Combine", "STANDARD_SUITE"]


def _compact(r_img, mask, times, keep):
    """The valid frames of the (B, T) selection keep, left-compacted."""
    B, T = mask.shape
    new_r = np.zeros_like(r_img)
    new_m = np.zeros_like(mask)
    new_t = np.zeros_like(times)
    for b in range(B):
        sel = np.nonzero(keep[b] & (mask[b] > 0.5))[0]
        n = len(sel)
        new_r[b, :n] = r_img[b, sel]
        new_t[b, :n] = times[b, sel]
        new_m[b, :n] = 1.0
    return new_r, new_m, new_t


class Identity:
    def __call__(self, data):
        return data


class HalfFPS:
    """Drop every second valid detection."""

    def __call__(self, data):
        mask = data["mask"]
        idx_in_valid = np.cumsum(mask > 0.5, axis=1) - 1
        keep = (idx_in_valid % 2 == 0) & (mask > 0.5)
        r, m, t = _compact(data["r_img"], mask, data["times"], keep)
        return {**data, "r_img": r, "mask": m, "times": t}


class DropBall:
    """Drop each detection with probability drop_prob."""

    def __init__(self, drop_prob=0.1, seed=42):
        self.drop_prob = drop_prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        mask = data["mask"]
        keep = ~(self.rng.random(mask.shape) < self.drop_prob)
        r, m, t = _compact(data["r_img"], mask, data["times"], keep)
        return {**data, "r_img": r, "mask": m, "times": t}


class DropTable:
    """Mark each keypoint invisible with probability drop_prob, its coordinates uniform in
    [-0.99, 0.99]."""

    def __init__(self, drop_prob=0.1, seed=42):
        self.drop_prob = drop_prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        table = data["table_img"].copy()
        B, N, _ = table.shape
        drop = self.rng.random((B, N)) < self.drop_prob
        rand = self.rng.uniform(-0.99, 0.99, (B, N, 2))
        table[..., :2] = np.where(drop[..., None], rand, table[..., :2])
        table[..., 2] = np.where(drop, 0.0, table[..., 2])
        return {**data, "table_img": table}


class Drop:
    def __init__(self, drop_ball_prob=0.1, drop_table_prob=0.1):
        self.ball = DropBall(drop_ball_prob)
        self.table = DropTable(drop_table_prob)

    def __call__(self, data):
        return self.table(self.ball(data))


class Combine:
    """HalfFPS, then Drop."""

    def __init__(self, drop_ball_prob=0.1, drop_table_prob=0.1):
        self.half = HalfFPS()
        self.drop = Drop(drop_ball_prob, drop_table_prob)

    def __call__(self, data):
        return self.drop(self.half(data))


STANDARD_SUITE = (
    ("Identity", lambda: Identity()),
    ("HalfFPS", lambda: HalfFPS()),
    ("Drop", lambda: Drop(0.1, 0.1)),
    ("Combine", lambda: Combine(0.1, 0.1)),
)
