"""Detection metrics, the heatmap loss and target rendering.

Port of the part of `upliftingtabletennis_tpu/eval/metrics.py` the detector trainer
uses: ball PCK@k px against the motion-blur streak (the distance to the segments
(min, center) and (center, max)), table PCK@k px over keypoints both predicted and
annotated visible, the weighted MSE heatmap loss (weight 100 where the target exceeds
0.1, mean over all elements) and Gaussian heatmap targets rendered on the device.

Visibility flags: 1 = visible, 0 = invisible. The functions take torch tensors on any
device and compute in their dtype (f32 in the trainer).
"""
from __future__ import annotations

import torch

__all__ = ["BALL_VISIBLE", "BALL_INVISIBLE", "point_segment_distance", "distance_to_streak",
           "pck_ball", "pck_keypoints", "weighted_mse_loss", "render_gaussian_heatmaps"]

BALL_VISIBLE = 1
BALL_INVISIBLE = 0


def point_segment_distance(p, e1, e2):
    """Distance from points (..., 2) to the segments (e1, e2)."""
    seg = e2 - e1
    L2 = (seg ** 2).sum(-1)
    t = torch.where(L2 > 1e-12, ((p - e1) * seg).sum(-1) / torch.clamp(L2, min=1e-12),
                    torch.zeros_like(L2))
    t = torch.clamp(t, 0.0, 1.0)
    closest = e1 + t[..., None] * seg
    return torch.linalg.vector_norm(p - closest, dim=-1)


def distance_to_streak(pred, gt_min, gt_center, gt_max):
    """The smaller distance to the two segments of the blur streak."""
    return torch.minimum(point_segment_distance(pred, gt_min, gt_center),
                         point_segment_distance(pred, gt_center, gt_max))


def pck_ball(preds, gts, gts_min, gts_max, tolerance):
    """Ball PCK@tolerance px against the blur streak: preds (N, 3) with visibility,
    gts / gts_min / gts_max (N, >=2). -1 when no prediction is visible."""
    valid = preds[..., 2] == BALL_VISIBLE
    d = distance_to_streak(preds[..., :2], gts_min[..., :2], gts[..., :2], gts_max[..., :2])
    correct = (d <= tolerance) & valid
    n_valid = valid.sum()
    return torch.where(n_valid > 0, correct.sum() / torch.clamp(n_valid, min=1),
                       torch.tensor(-1.0, device=preds.device))


def pck_keypoints(preds, gts, tolerance):
    """Table PCK over keypoints predicted and annotated visible: preds, gts (N, C, 3).
    -1 when there is none."""
    m = (preds[..., 2] == BALL_VISIBLE) & (gts[..., 2] == BALL_VISIBLE)
    d = torch.linalg.vector_norm(preds[..., :2] - gts[..., :2], dim=-1)
    correct = (d <= tolerance) & m
    n = m.sum()
    return torch.where(n > 0, correct.sum() / torch.clamp(n, min=1),
                       torch.tensor(-1.0, device=preds.device))


def weighted_mse_loss(pred, target):
    """mean(w (pred - target)^2) with w = 100 where target > 0.1, else 1."""
    w = torch.where(target > 0.1, 100.0, 1.0)
    return (w * (pred - target) ** 2).mean()


def render_gaussian_heatmaps(coords, visibility, height: int, width: int, sigma: float = 6.0):
    """Gaussian targets exp(-d^2 / (2 sigma^2)) at pixel positions coords (..., 2) of a
    height x width map; an invisible point renders as zeros. Returns (..., height, width)
    f32 on coords' device."""
    dev = coords.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    c = coords.reshape(-1, 2).float()
    dy2 = (ys[None, :] - c[:, 1:2]) ** 2  # (N, H)
    dx2 = (xs[None, :] - c[:, 0:1]) ** 2  # (N, W)
    hm = torch.exp(-(dy2[:, :, None] + dx2[:, None, :]) / (2.0 * sigma ** 2))
    hm = hm * (visibility.reshape(-1, 1, 1) > 0)
    return hm.reshape(*coords.shape[:-1], height, width)
