"""Uplifting-model training step: the loss, clip + Adam + EMA, and the validation metrics.

Port of `upliftingtabletennis_tpu/train/uplifting_train.py`:

  loss_rot = sum_b || omega_b - omega_hat_b ||_2            (+1e-12 under the root)
  loss_pos = sum(squared error * mask) / sum(mask)          (not 3 sum(mask))
  loss     = loss_rot + loss_pos

then optax's `chain(clip_by_global_norm(5.0), adam(lr))` written out (the clip keeps g
below the global norm and gives (g / norm) * max_norm at or above it; Adam with b1 0.9,
b2 0.999, eps 1e-8 outside the root, eps_root 0 and bias correction; the update added
to the parameters), then the EMA of the parameters, ema = d ema + (1 - d) params. The
optimizer runs over the parameter list with `torch._foreach_*`: a handful of launches per
operation, not one per tensor. Parameters and the optimizer state are f32, as in JAX.

Data parallelism (`train_step(..., ddp=...)`, one rank's slice of the global batch under
`DistributedDataParallel`): the loss is not a mean over samples, so each rank divides
its masked position sum by the mask summed over the whole batch (all-reduced) and scales
its loss by the world size; DDP's mean of the ranks' gradients is then the global batch's
gradient, which the clip, Adam and the EMA see on every rank.

`eval_step` and `val2d_step` give the summed validation metrics of a batch (the caller
divides by the count); `spin_classification_metrics` is host numpy, with the ROC-AUC as
the Mann-Whitney rank statistic (ties averaged), which needs no scikit-learn.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from upliftingtabletennis_torch.core.geometry import (HEIGHT, WIDTH, transform_rotation_axes,
                                                      world2img)
from upliftingtabletennis_torch.parallel import distributed as dist_util

__all__ = ["CLIP_NORM", "ADAM_B1", "ADAM_B2", "ADAM_EPS", "Batch", "TrainState", "batch_from",
           "init_train_state", "loss_fn", "apply_update", "train_step", "eval_step",
           "val2d_step", "roc_auc", "spin_classification_metrics"]

CLIP_NORM = 5.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Batch(NamedTuple):
    """One training batch."""

    ball_img: torch.Tensor   # (B, T, 2) normalised 2D detections
    table_img: torch.Tensor  # (B, 13, 3) normalised keypoints + visibility
    mask: torch.Tensor       # (B, T) {0, 1}
    r_world: torch.Tensor    # (B, T, 3) ground-truth 3D trajectory
    rotation: torch.Tensor   # (B, 3) ground-truth spin (world frame)
    times: torch.Tensor      # (B, T) seconds


def batch_from(sample: dict) -> Batch:
    """The Batch of an augmented sample dict (`data/augment.py`)."""
    return Batch(sample["r_img"], sample["table_img"], sample["mask"], sample["r_world"],
                 sample["rotation"], sample["times"])


class TrainState(NamedTuple):
    """The trainer's state: the model's parameters (its own tensors, in
    `model.parameters()` order), their EMA, Adam's moments and the step count."""

    params: List[torch.Tensor]
    ema: List[torch.Tensor]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: List[int]  # one element, so that apply_update counts in place


def init_train_state(model: torch.nn.Module) -> TrainState:
    params = list(model.parameters())
    return TrainState(params, [p.detach().clone() for p in params],
                      [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params],
                      [0])


def loss_fn(model, batch: Batch, transform_mode: str = "global", mask_total=None,
            world: int = 1):
    """(loss, (loss_rot, loss_pos)) of the model on the batch; with transform_mode 'local'
    the network predicts the spin in the ball's flight frame. For one rank's slice of a
    global batch: mask_total, the mask summed over the global batch (the position term's
    divisor), and world, the number of ranks, which scales the loss returned; loss_rot and
    loss_pos are then the rank's shares of the global batch's terms."""
    pred_rot, pred_pos = model(batch.ball_img, batch.table_img, batch.mask, batch.times)
    rotation = batch.rotation
    if transform_mode == "local":
        rotation = transform_rotation_axes(rotation, batch.r_world)
    loss_rot = torch.sqrt(((pred_rot - rotation) ** 2).sum(1) + 1e-12).sum()
    denom = batch.mask.sum() if mask_total is None else mask_total
    loss_pos = (((pred_pos - batch.r_world) ** 2) * batch.mask[..., None]).sum() / denom
    loss = loss_rot + loss_pos
    return world * loss, (loss_rot, loss_pos)


@torch.no_grad()
def apply_update(state: TrainState, grads, lr: float = 1e-4, ema_decay: float = 0.999,
                 max_norm: float = CLIP_NORM) -> None:
    """One optimizer step in place: the global-norm clip, Adam, then the EMA."""
    grads = list(grads)
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm  # kept exactly (divided and multiplied by 1) below the norm
    one = torch.ones_like(g_norm)
    grads = torch._foreach_div(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))

    state.step[0] += 1
    count = state.step[0]
    torch._foreach_mul_(state.mu, ADAM_B1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - ADAM_B2)
    torch._foreach_mul_(state.nu, ADAM_B2)
    torch._foreach_add_(state.nu, sq)
    # bias corrections in f32, as optax takes decay ** count
    c1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count)
    c2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count)
    denom = torch._foreach_div(state.nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_div(state.mu, c1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(state.params, update)

    torch._foreach_mul_(state.ema, ema_decay)
    torch._foreach_add_(state.ema, torch._foreach_mul(state.params, 1.0 - ema_decay))


def train_step(model, state: TrainState, batch: Batch, lr: float = 1e-4,
               ema_decay: float = 0.999, transform_mode: str = "global",
               ddp=None) -> Dict[str, torch.Tensor]:
    """Forward, backward, `apply_update`. Returns the losses as device scalars (no sync).

    ddp: `model` wrapped in `DistributedDataParallel`, `batch` this rank's slice of the
    global batch; the gradients and the losses returned are the global batch's."""
    if ddp is None:
        loss, (loss_rot, loss_pos) = loss_fn(model, batch, transform_mode)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
    else:
        loss, (loss_rot, loss_pos) = loss_fn(ddp, batch, transform_mode,
                                             dist_util.all_reduce_sum(batch.mask.sum()),
                                             dist_util.process_count())
        loss.backward()  # DDP averages the gradients over the ranks
        grads = [p.grad for p in state.params]
        for p in state.params:
            p.grad = None
        loss_rot, loss_pos = dist_util.all_reduce_sum(torch.stack([loss_rot, loss_pos]))
        loss = loss_rot + loss_pos
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads)]
    apply_update(state, grads, lr, ema_decay)
    return {"loss": loss.detach(), "loss_rot": loss_rot.detach(), "loss_pos": loss_pos.detach()}


def _norm(x):
    return torch.linalg.vector_norm(x, dim=1)


def _forward(model, outputs, *inputs):
    return model(*inputs) if outputs is None else outputs


@torch.no_grad()
def eval_step(model, batch: Batch, transform_mode: str = "global",
              outputs=None) -> Dict[str, torch.Tensor]:
    """Summed synthetic-validation metrics of a batch: the spin error in the flight frame
    (metric), its magnitude error, its angle in degrees, the mean per-frame position
    error, and per axis the sign agreement counts tp, tn, fp, fn; and `count`. outputs:
    the model's (spin, positions) on the batch, if the caller has them."""
    pred_rot, pred_pos = _forward(model, outputs, batch.ball_img, batch.table_img, batch.mask,
                                  batch.times)
    rotation = transform_rotation_axes(batch.rotation, batch.r_world)
    if transform_mode == "global":
        pred_rot = transform_rotation_axes(pred_rot, batch.r_world)
    err = pred_rot - rotation
    metric = torch.sqrt((err ** 2).sum(1)).sum()
    metric_abs = torch.abs(_norm(pred_rot) - _norm(rotation)).sum()
    cosang = (pred_rot * rotation).sum(1) / (_norm(pred_rot) * _norm(rotation) + 1e-12)
    metric_angle = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0))).sum()
    perframe = torch.sqrt(((pred_pos - batch.r_world) ** 2).sum(-1))
    metric_pos = ((perframe * batch.mask).sum(1) / batch.mask.sum(1)).sum()
    gt, pr = torch.sign(rotation), torch.sign(pred_rot)
    return {"metric": metric, "metric_abs": metric_abs, "metric_angle": metric_angle,
            "metric_position": metric_pos,
            "tp": ((gt == 1) & (pr == 1)).sum(0), "tn": ((gt == -1) & (pr == -1)).sum(0),
            "fp": ((gt == -1) & (pr == 1)).sum(0), "fn": ((gt == 1) & (pr == -1)).sum(0),
            "count": batch.ball_img.shape[0]}


@torch.no_grad()
def val2d_step(model, r_img, table_img, mask, times, Mint, Mext,
               transform_mode: str = "global", outputs=None) -> Dict[str, torch.Tensor]:
    """2D-reprojection validation: the predicted positions projected through the stored
    cameras against the (denormalised) 2D inputs, masked mean per trajectory, summed
    (`metric_2d`); the spin's flight-frame omega_y per trajectory (`spin_score`)."""
    pred_rot, pred_pos = _forward(model, outputs, r_img, table_img, mask, times)
    if transform_mode == "global":
        pred_rot = transform_rotation_axes(pred_rot, pred_pos)
    wh = torch.tensor([WIDTH, HEIGHT], dtype=torch.float32, device=r_img.device)
    pred_px = world2img(pred_pos, Mext[:, None], Mint[:, None])
    d = torch.sqrt(((pred_px - r_img * wh) ** 2).sum(-1) + 1e-12)
    per_traj = (d * mask).sum(1) / mask.sum(1)
    return {"metric_2d": per_traj.sum(), "spin_score": pred_rot[:, 1],
            "count": r_img.shape[0]}


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of x, tied values given the mean of their ranks."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    ranks = np.empty(len(x), np.float64)
    start = 0
    for end in range(1, len(xs) + 1):
        if end == len(xs) or xs[end] != xs[start]:
            ranks[order[start:end]] = (start + end + 1) / 2.0
            start = end
    return ranks


def roc_auc(y: np.ndarray, s: np.ndarray) -> float:
    """Area under the ROC curve of scores s for binary labels y: the Mann-Whitney U of the
    positives over n_pos n_neg, ties counted one half. NaN with one class only."""
    y = np.asarray(y).astype(bool)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r = _average_ranks(np.asarray(s, np.float64))
    return float((r[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def spin_classification_metrics(spin_scores, spin_classes) -> Dict[str, float]:
    """Accuracy, macro F1 and ROC-AUC of omega_y scores against the labels (1 topspin,
    2 backspin, others unannotated and left out)."""
    scores, labels = np.asarray(spin_scores), np.asarray(spin_classes)
    annotated = (labels == 1) | (labels == 2)
    y = (labels[annotated] == 1).astype(int)
    s = scores[annotated]
    tp = int(np.sum((y == 1) & (s > 0)))
    fn = int(np.sum((y == 1) & (s <= 0)))
    tn = int(np.sum((y == 0) & (s < 0)))
    fp = int(np.sum((y == 0) & (s >= 0)))
    total = max(tp + tn + fp + fn, 1)
    f1_plus = 2 * tp / max(2 * tp + fp + fn, 1)
    f1_minus = 2 * tn / max(2 * tn + fn + fp, 1)
    return {"accuracy": (tp + tn) / total, "macro_f1": (f1_plus + f1_minus) / 2,
            "roc_auc": roc_auc(y, s)}
