"""Generic keypoint accuracy metrics (the mmpose family), batched in torch.

Port of `upliftingtabletennis_tpu/eval/keypoint_metrics.py`: masked normalised distances
with the -1 "invalid" sentinel, PCK per keypoint and averaged, the AUC of the PCK curve,
NME, EPE, and argmax predictions from heatmaps (2D and 3D). The quirks of the mmpose
originals are kept, as the JAX module keeps them:

* a row whose `normalize` has any zero component is invalid as a whole, while
  non-positive entries elsewhere are clamped to 1e6;
* `pose_pck_accuracy`'s default normalize is (H, W) per row: H scales x and W scales y;
* a keypoint with no valid sample has accuracy -1 and is left out of the average and
  of the valid count;
* `get_max_preds` takes the first maximum (argmax order) and gives -1 where the maximum
  is not positive.

The functions take tensors or arrays (N, K, D) on any device; array inputs become f32
CPU tensors. They return tensors.
"""
from __future__ import annotations

import torch

__all__ = ["get_max_preds", "get_max_preds_3d", "keypoint_pck_accuracy", "pose_pck_accuracy",
           "keypoint_auc", "keypoint_nme", "keypoint_epe"]


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=dtype)


def _calc_distances(preds, targets, mask, normalize) -> torch.Tensor:
    """Masked normalised distances (K, N), -1 where invalid."""
    preds, targets = _t(preds), _t(targets)
    mask = _t(mask, torch.bool).bool()
    normalize = _t(normalize).to(preds.dtype)
    row_bad = (normalize == 0).any(dim=1)
    m = mask & ~row_bad[:, None]
    norm = torch.where(normalize <= 0, torch.full_like(normalize, 1e6), normalize)
    d = torch.linalg.vector_norm((preds - targets) / norm[:, None, :], dim=-1)
    return torch.where(m, d, torch.full_like(d, -1.0)).T


def _distance_acc(distances, thr=0.5) -> torch.Tensor:
    """The share of valid distances below thr along the last axis; -1 where none is
    valid. distances (..., N) with the -1 sentinel."""
    distances = _t(distances)
    valid = distances != -1
    n = valid.sum(-1)
    hits = ((distances < thr) & valid).sum(-1)
    return torch.where(n > 0, hits / torch.clamp(n, min=1),
                       torch.full(n.shape, -1.0, device=distances.device))


def get_max_preds(heatmaps):
    """Argmax predictions from (N, K, H, W) heatmaps: (preds (N, K, 2) x, y; maxvals
    (N, K, 1)), preds -1 where the maximum is not positive."""
    heatmaps = _t(heatmaps)
    N, K, _, W = heatmaps.shape
    maxvals, idx = heatmaps.reshape(N, K, -1).max(dim=2)
    maxvals = maxvals[..., None]
    preds = torch.stack([idx % W, idx // W], dim=-1).to(torch.float32)
    return torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0)), maxvals


def get_max_preds_3d(heatmaps):
    """Argmax predictions from (N, K, D, H, W) volumes: ((N, K, 3) x, y, z; (N, K, 1))."""
    heatmaps = _t(heatmaps)
    N, K, D, H, W = heatmaps.shape
    maxvals, idx = heatmaps.reshape(N, K, -1).max(dim=2)
    maxvals = maxvals[..., None]
    preds = torch.stack([idx % W, (idx // W) % H, idx // (H * W)], dim=-1).to(torch.float32)
    return torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0)), maxvals


def _average_valid(acc: torch.Tensor):
    """(the mean over the entries >= 0 of the last axis, 0 with none; their count)."""
    valid = acc >= 0
    cnt = valid.sum(-1)
    total = torch.where(valid, acc, torch.zeros_like(acc)).sum(-1)
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.zeros_like(total)), cnt


def keypoint_pck_accuracy(pred, gt, mask, thr, normalize):
    """PCK per keypoint (K,), their average over the valid keypoints and the count of
    valid keypoints."""
    acc = _distance_acc(_calc_distances(pred, gt, mask, normalize), thr)
    avg, cnt = _average_valid(acc)
    return acc, avg, cnt


def pose_pck_accuracy(output, target, mask, thr=0.05, normalize=None):
    """PCK of the argmax predictions of heatmaps (N, K, H, W) against the target's. The
    default normalize is (H, W) per row."""
    output = _t(output)
    N, K, H, W = output.shape
    if K == 0:
        return None, 0, 0
    if normalize is None:
        normalize = torch.tensor([[H, W]], dtype=torch.float32).repeat(N, 1)
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    return keypoint_pck_accuracy(pred, gt, mask, thr, normalize)


def keypoint_auc(pred, gt, mask, normalize, num_step=20):
    """The area under the PCK curve over the thresholds i / num_step, i < num_step: one
    batched pass, as the valid set does not depend on the threshold."""
    pred = _t(pred)
    nor = torch.full((pred.shape[0], 2), float(normalize), dtype=torch.float32)
    d = _calc_distances(pred, gt, mask, nor)  # (K, N)
    thrs = torch.arange(num_step, dtype=torch.float32) / num_step  # (S,)
    acc = _distance_acc(d[None], thrs[:, None, None])  # (S, K)
    return _average_valid(acc)[0].mean()


def keypoint_nme(pred, gt, mask, normalize_factor):
    """The normalised mean error over the valid joints."""
    d = _calc_distances(pred, gt, mask, normalize_factor)
    valid = d != -1
    return torch.where(valid, d, torch.zeros_like(d)).sum() / torch.clamp(valid.sum(), min=1)


def keypoint_epe(pred, gt, mask):
    """The average end-point error, in the inputs' units."""
    pred = _t(pred)
    ones = torch.ones((pred.shape[0], pred.shape[2]), dtype=torch.float32)
    return keypoint_nme(pred, gt, mask, ones)
