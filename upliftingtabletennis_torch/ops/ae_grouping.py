"""Associative-embedding heatmap grouping (bottom-up multi-person parsing).

Port of `upliftingtabletennis_tpu/ops/ae_grouping.py`, the `HeatmapParser` of
the vendored ViTPose stack:

* candidate extraction, local-max NMS (`nms_heatmaps`) and the per-joint top-k
  with its tag gather (`top_k_candidates`), runs in torch on the heatmaps'
  device. The top-k is a stable descending sort, so that ties (most entries
  are 0 after the NMS) go to the lowest index first, as `jax.lax.top_k`;
* tag matching (`match_by_tag`: greedy per-joint Hungarian assignment with
  scipy's `linear_sum_assignment`), the quarter-offset `adjust_poses`, the
  missing-joint `refine_pose` and the DARK-UDP refinement run on the host in
  numpy, as in the JAX package, of which they are a copy.

Grouped poses per image: an array (P, K, 3 + L) of (x, y, score, tag...) rows,
plus per-person scores.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["HeatmapParser", "nms_heatmaps", "top_k_candidates", "match_by_tag",
           "adjust_poses", "refine_pose"]


def nms_heatmaps(heatmaps: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Suppress non-local-maxima: keep values equal to their kxk max pool, 0 elsewhere.
    heatmaps (N, K, H, W). The pool's implicit padding is -inf, as in the JAX function."""
    pooled = F.max_pool2d(heatmaps, kernel, stride=1, padding=(kernel - 1) // 2)
    return torch.where(pooled == heatmaps, heatmaps, torch.zeros_like(heatmaps))


def top_k_candidates(heatmaps: torch.Tensor, tags: torch.Tensor, max_people: int = 30,
                     kernel: int = 5, tag_per_joint: bool = True):
    """NMS + per-joint top-k with tag gather.

    heatmaps (N, K, H, W); tags (N, K_tag, H, W, L) with K_tag == K when
    tag_per_joint else 1. Returns val_k (N, K, M), loc_k (N, K, M, 2) as (x, y),
    tag_k (N, K, M, L); ties in value go to the lowest flat index first.
    """
    N, K, H, W = heatmaps.shape
    flat = nms_heatmaps(heatmaps, kernel).reshape(N, K, H * W)
    srt = torch.sort(flat, dim=-1, descending=True, stable=True)
    val_k, ind = srt.values[..., :max_people], srt.indices[..., :max_people]  # (N, K, M)
    loc_k = torch.stack([ind % W, ind // W], dim=-1)  # (x, y)
    L = tags.shape[-1]
    tags_flat = tags.reshape(N, tags.shape[1], H * W, L)
    if not tag_per_joint:
        tags_flat = tags_flat.expand(N, K, H * W, L)
    tag_k = torch.gather(tags_flat, 2, ind[..., None].expand(N, K, ind.shape[-1], L))
    return val_k, loc_k, tag_k


def _joint_order(num_joints: int) -> List[int]:
    """COCO torso-first grouping order for 17 joints, identity otherwise
    (ref: group.py:135-141)."""
    if num_joints == 17:
        return [i - 1 for i in [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16, 17]]
    return list(range(num_joints))


def match_by_tag(
    val_k: np.ndarray,
    loc_k: np.ndarray,
    tag_k: np.ndarray,
    *,
    detection_threshold: float = 0.1,
    tag_threshold: float = 1.0,
    max_num_people: int = 30,
    use_detection_val: bool = True,
    ignore_too_much: bool = False,
    joint_order: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Greedy per-joint Hungarian grouping for ONE image
    (ref: group.py:28-116).

    val_k (K, M), loc_k (K, M, 2), tag_k (K, M, L) ->
    poses (P, K, 3 + L): rows are (x, y, score, tag...), zero where a
    joint was not assigned.
    """
    from scipy.optimize import linear_sum_assignment

    K, M = val_k.shape
    L = tag_k.shape[-1]
    order = list(joint_order) if joint_order is not None else _joint_order(K)

    group_joints: List[np.ndarray] = []  # each (K, 3+L)
    group_tags: List[List[np.ndarray]] = []  # per group: list of (L,) tags
    group_keys: List[float] = []

    def open_group(idx, tag, joint):
        # The reference keys its joint_dict by tag[0], so a candidate whose
        # first tag value exactly equals an existing group's key merges into
        # that group instead of opening a new one
        # (ref: group.py:110-113 joint_dict.setdefault).
        key = float(tag[0])
        if key in group_keys:
            g = group_keys.index(key)
            group_joints[g][idx] = joint
            group_tags[g].append(tag)
            return
        pose = np.zeros((K, 3 + L), np.float32)
        pose[idx] = joint
        group_joints.append(pose)
        group_tags.append([tag])
        group_keys.append(key)

    for step, idx in enumerate(order):
        keep = val_k[idx] > detection_threshold
        if not keep.any():
            continue
        joints = np.concatenate(
            [loc_k[idx][keep].astype(np.float32),
             val_k[idx][keep, None].astype(np.float32),
             tag_k[idx][keep].astype(np.float32)],
            axis=1,
        )  # (m, 3+L)
        tags = tag_k[idx][keep].astype(np.float32)  # (m, L)

        if step == 0 or not group_joints:
            for tag, joint in zip(tags, joints):
                open_group(idx, tag, joint)
            continue

        active = list(range(min(len(group_joints), max_num_people)))
        if ignore_too_much and len(active) == max_num_people:
            continue
        mean_tags = np.stack([np.mean(group_tags[g], axis=0) for g in active])
        diff = np.linalg.norm(joints[:, None, 3:] - mean_tags[None], axis=2)
        diff_saved = diff.copy()
        cost = diff
        if use_detection_val:
            cost = np.round(diff) * 100 - joints[:, 2:3]
        m, g = cost.shape
        if m > g:  # allow unmatched candidates to open new groups
            cost = np.concatenate([cost, np.full((m, m - g), 1e10, np.float32)], axis=1)
        rows, cols = linear_sum_assignment(cost)
        for row, col in zip(rows, cols):
            if col < g and diff_saved[row, col] < tag_threshold:
                group_joints[active[col]][idx] = joints[row]
                group_tags[active[col]].append(tags[row])
            else:
                open_group(idx, tags[row], joints[row])

    if not group_joints:
        return np.zeros((0, K, 3 + L), np.float32)
    return np.stack(group_joints).astype(np.float32)


def _quarter_offsets(heatmaps: np.ndarray, x: np.ndarray, y: np.ndarray,
                     joint_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized +-0.25 gradient-sign nudge (ref: group.py:259-278).
    heatmaps (K, H, W); x, y, joint_idx flat int arrays."""
    K, H, W = heatmaps.shape
    right = heatmaps[joint_idx, y, np.minimum(W - 1, x + 1)]
    left = heatmaps[joint_idx, y, np.maximum(0, x - 1)]
    down = heatmaps[joint_idx, np.minimum(H - 1, y + 1), x]
    up = heatmaps[joint_idx, np.maximum(0, y - 1), x]
    dx = np.where(right > left, 0.25, -0.25)
    dy = np.where(down > up, 0.25, -0.25)
    return dx, dy


def adjust_poses(poses: np.ndarray, heatmaps: np.ndarray) -> np.ndarray:
    """Quarter-offset + half-pixel adjust of grouped poses for one image
    (ref: group.py:244-279). poses (P, K, 3+L); heatmaps (K, H, W)."""
    if poses.shape[0] == 0:
        return poses
    P, K = poses.shape[:2]
    det = poses[..., 2] > 0
    p, k = np.nonzero(det)
    if len(p) == 0:
        return poses
    x = poses[p, k, 0].astype(int)
    y = poses[p, k, 1].astype(int)
    dx, dy = _quarter_offsets(heatmaps, x, y, k)
    poses[p, k, 0] = poses[p, k, 0] + dx + 0.5
    poses[p, k, 1] = poses[p, k, 1] + dy + 0.5
    return poses


def refine_pose(heatmaps: np.ndarray, tags: np.ndarray, pose: np.ndarray,
                use_udp: bool = False) -> np.ndarray:
    """Fill in undetected joints of one pose from the tag-consistent
    heatmap maximum (ref: group.py:281-358), vectorized over joints.

    heatmaps (K, H, W); tags (K, H, W) or (K, H, W, L); pose (K, 3+L).
    """
    K, H, W = heatmaps.shape
    if tags.ndim == 3:
        tags = tags[..., None]
    det = pose[:, 2] > 0
    if not det.any():
        return pose
    xi = np.clip(pose[det, 0].astype(int), 0, W - 1)
    yi = np.clip(pose[det, 1].astype(int), 0, H - 1)
    prev_tag = tags[np.nonzero(det)[0], yi, xi].mean(axis=0)  # (L,)

    dist = np.sqrt(((tags - prev_tag) ** 2).sum(axis=-1))  # (K, H, W)
    norm = heatmaps - np.round(dist)
    flat_idx = norm.reshape(K, -1).argmax(axis=1)
    y0, x0 = np.unravel_index(flat_idx, (H, W))
    val = heatmaps[np.arange(K), y0, x0]
    x = x0.astype(np.float32)
    y = y0.astype(np.float32)
    if not use_udp:
        x, y = x + 0.5, y + 0.5
    dx, dy = _quarter_offsets(heatmaps, x0, y0, np.arange(K))
    x, y = x + dx, y + dy

    fill = (val > 0) & ~det
    pose[fill, 0] = x[fill]
    pose[fill, 1] = y[fill]
    pose[fill, 2] = val[fill]
    return pose


def _post_dark_udp(coords: np.ndarray, heatmaps: np.ndarray, kernel: int = 3) -> np.ndarray:
    """DARK-UDP sub-pixel refinement at each pose's own coordinates
    (ref: top_down_eval.py:354-414, numpy port of the bottom-up B=1 case).

    coords (P, K, 2) float pixel coords; heatmaps (K, H, W). Blur with a
    separable Gaussian (cv2 sigma convention), clip+log, then a one-step
    Newton update using the 3x3 log-heatmap Taylor expansion evaluated at
    each pose's truncated integer coordinate.
    """
    P, K = coords.shape[:2]
    _, H, W = heatmaps.shape
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = kernel // 2
    xk = np.arange(-r, r + 1, dtype=np.float32)
    g = np.exp(-(xk**2) / (2 * sigma**2))
    g /= g.sum()
    # separable blur with reflect-101 borders (cv2.GaussianBlur default)
    hm = np.pad(heatmaps.astype(np.float32), ((0, 0), (r, r), (r, r)), mode="reflect")
    hm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 2, hm)
    hm = np.apply_along_axis(lambda m: np.convolve(m, g, mode="valid"), 1, hm)
    np.clip(hm, 0.001, 50, hm)
    np.log(hm, hm)
    pad = np.pad(hm, ((0, 0), (1, 1), (1, 1)), mode="edge")  # (K, H+2, W+2)

    x = np.clip(coords[..., 0].astype(int), 0, W - 1) + 1  # (P, K) in padded frame
    y = np.clip(coords[..., 1].astype(int), 0, H - 1) + 1
    kk = np.broadcast_to(np.arange(K)[None], (P, K))

    def v(dy, dx):
        return pad[kk, y + dy, x + dx]

    dx1 = 0.5 * (v(0, 1) - v(0, -1))
    dy1 = 0.5 * (v(1, 0) - v(-1, 0))
    dxx = v(0, 1) - 2 * v(0, 0) + v(0, -1)
    dyy = v(1, 0) - 2 * v(0, 0) + v(-1, 0)
    dxy = 0.5 * (v(1, 1) - v(0, 1) - v(1, 0) + 2 * v(0, 0) - v(0, -1) - v(-1, 0) + v(-1, -1))
    hess = np.stack(
        [np.stack([dxx, dxy], -1), np.stack([dxy, dyy], -1)], -2
    )  # (P, K, 2, 2)
    hess = np.linalg.inv(hess + np.finfo(np.float32).eps * np.eye(2))
    deriv = np.stack([dx1, dy1], -1)[..., None]  # (P, K, 2, 1)
    return coords - np.einsum("pkmn,pknj->pkmj", hess, deriv)[..., 0]


class HeatmapParser:
    """Bottom-up associative-embedding parser.

    cfg keys: num_joints, max_num_people, detection_threshold, tag_threshold,
    use_detection_val, ignore_too_much, tag_per_joint, nms_kernel, use_udp,
    score_per_joint. The candidate extraction runs on `device` (the card unless
    the caller asks for the CPU); the grouping on the host.
    """

    def __init__(self, cfg: dict, device="cuda"):
        self.device = resolve_device(device)
        self.num_joints = cfg["num_joints"]
        self.max_num_people = cfg.get("max_num_people", 30)
        self.detection_threshold = cfg.get("detection_threshold", 0.1)
        self.tag_threshold = cfg.get("tag_threshold", 1.0)
        self.use_detection_val = cfg.get("use_detection_val", True)
        self.ignore_too_much = cfg.get("ignore_too_much", False)
        self.tag_per_joint = cfg.get("tag_per_joint", True)
        self.nms_kernel = cfg.get("nms_kernel", 5)
        self.use_udp = cfg.get("use_udp", False)
        self.score_per_joint = cfg.get("score_per_joint", False)

    def top_k(self, heatmaps, tags):
        out = top_k_candidates(
            torch.as_tensor(np.asarray(heatmaps, np.float32), device=self.device),
            torch.as_tensor(np.asarray(tags, np.float32), device=self.device),
            max_people=self.max_num_people, kernel=self.nms_kernel,
            tag_per_joint=self.tag_per_joint,
        )
        return tuple(t.cpu().numpy() for t in out)

    def match(self, val_k, loc_k, tag_k):
        return [
            match_by_tag(
                v, l, t,
                detection_threshold=self.detection_threshold,
                tag_threshold=self.tag_threshold,
                max_num_people=self.max_num_people,
                use_detection_val=self.use_detection_val,
                ignore_too_much=self.ignore_too_much,
                joint_order=_joint_order(self.num_joints),
            )
            for v, l, t in zip(val_k, loc_k, tag_k)
        ]

    def parse(self, heatmaps, tags, adjust: bool = True, refine: bool = True):
        """heatmaps (N, K, H, W); tags (N, K|1, H, W, L) arrays.
        Returns (list of (P, K, 3+L) pose arrays, scores for image 0).
        """
        heatmaps = np.asarray(heatmaps, np.float32)
        tags_np = np.asarray(tags, np.float32)
        results = self.match(*self.top_k(heatmaps, tags_np))

        if adjust:
            if self.use_udp:
                for i, poses in enumerate(results):
                    if poses.shape[0] == 0:
                        continue
                    # DARK/UDP refinement around each pose's own coordinates
                    poses[..., :2] = _post_dark_udp(
                        poses[..., :2].copy(), heatmaps[i]
                    )
            else:
                results = [adjust_poses(p, heatmaps[i]) for i, p in enumerate(results)]

        poses0 = results[0]
        if self.score_per_joint:
            scores = [p[:, 2] for p in poses0]
        else:
            scores = [float(p[:, 2].mean()) for p in poses0]

        if refine:
            tag0 = tags_np[0]
            if not self.tag_per_joint:
                tag0 = np.tile(tag0, (self.num_joints, 1, 1, 1))
            refined = [
                refine_pose(heatmaps[0], tag0, p.copy(), use_udp=self.use_udp)
                for p in poses0
            ]
            results = [np.stack(refined) if refined else poses0]

        return results, scores
