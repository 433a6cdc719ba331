"""Detection metrics, the heatmap loss and target rendering.

Port of `upliftingtabletennis_tpu/eval/metrics.py`: ball PCK@k px against the
motion-blur streak (the distance to the segments (min, center) and (center, max)), table
PCK@k px over keypoints both predicted and annotated visible, the mean pixel distance
(and the mean streak distance) over detections that are not the -100 sentinel, the
visible/invisible accuracy of a 2-logit head, the weighted MSE heatmap loss (weight 100
where the target exceeds 0.1, mean over all elements) and Gaussian heatmap targets
rendered on the device.

Visibility flags: 1 = visible, 0 = invisible. The functions take torch tensors on any
device and compute in their dtype (f32 in the trainer).
"""
from __future__ import annotations

import torch

__all__ = ["BALL_VISIBLE", "BALL_INVISIBLE", "point_segment_distance", "distance_to_streak",
           "pck_ball", "pck_keypoints", "average_distance", "average_distance_to_streak",
           "acc_visible_invisible", "weighted_mse_loss", "render_gaussian_heatmaps"]

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


def _mean_over_valid(d, preds):
    """The mean of d over the detections whose x and y are both above the -100 sentinel;
    10000 when there is none."""
    valid = (preds[..., 0] > -100) & (preds[..., 1] > -100)
    n = valid.sum()
    return torch.where(n > 0, (d * valid).sum() / torch.clamp(n, min=1),
                       torch.tensor(10000.0, device=preds.device))


def average_distance(preds, gts):
    """Mean pixel distance over valid (> -100 sentinel) detections; 10000 when nothing is
    valid."""
    return _mean_over_valid(torch.linalg.vector_norm(preds[..., :2] - gts[..., :2], dim=-1),
                            preds)


def average_distance_to_streak(preds, gt_min, gt, gt_max):
    """Mean distance to the blur streak over valid detections; 10000 when nothing is
    valid."""
    return _mean_over_valid(
        distance_to_streak(preds[..., :2], gt_min[..., :2], gt[..., :2], gt_max[..., :2]), preds)


def acc_visible_invisible(cls_logits, label_vis):
    """(accuracy on the visible labels, accuracy on the invisible ones) of 2-logit heads
    (N, 2): visible is predicted where logit 0 <= logit 1. The invisible accuracy is 0
    without an invisible label."""
    gt_vis = label_vis == BALL_VISIBLE
    gt_invis = label_vis == BALL_INVISIBLE
    pred_vis = cls_logits[:, 0] <= cls_logits[:, 1]
    acc_vis = (pred_vis & gt_vis).sum() / torch.clamp(gt_vis.sum(), min=1)
    n_invis = gt_invis.sum()
    acc_invis = torch.where(n_invis > 0, (~pred_vis & gt_invis).sum() / torch.clamp(n_invis, min=1),
                            torch.tensor(0.0, device=cls_logits.device))
    return acc_vis, acc_invis


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
