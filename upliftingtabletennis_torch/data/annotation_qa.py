"""Annotation quality checks: left/right keypoint swaps and camera statistics.

Port of `upliftingtabletennis_tpu/data/annotation_qa.py`:

* table keypoints come in mirrored pairs, and annotators sometimes swap them: calibrate
  from the keypoints as annotated and with each pair swapped, and flag a pair whose swap
  lowers the mean reprojection error by more than a margin (`detect_left_right_swaps`,
  `fix_left_right_swaps`). The calibration is the port's (`core/calibration.py`), without
  RANSAC, on `device` (the card unless the caller asks for the CPU);
* fx, fy, the camera's distance and azimuth over calibrated frames (`camera_statistics`);
* `render_annotation_check`: the frame with the keypoints (lime, or red where flagged),
  the table reprojected after a RANSAC calibration (orange crosses and wireframe) and a
  title, drawn with numpy at the frame's size (the JAX module plots with matplotlib).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["LEFT_RIGHT_PAIRS", "detect_left_right_swaps", "fix_left_right_swaps",
           "camera_statistics", "render_annotation_check"]

# mirrored (left, right) keypoint index pairs (0-based, geometry.TABLE_POINTS)
LEFT_RIGHT_PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (9, 10))
LIME, RED, ORANGE, BLACK = (0, 255, 0), (255, 0, 0), (255, 165, 0), (0, 0, 0)


def _reproj_error(keypoints: np.ndarray, resolution, device, dtype) -> float:
    """The mean reprojection error (px) of the visible keypoints after calibrating from
    them (no RANSAC); inf with fewer than 6."""
    from upliftingtabletennis_torch.core.calibration import calibrate_camera
    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, world2img

    vis = (keypoints[:, 2] > 0).astype(np.float32)
    if vis.sum() < 6:
        return float("inf")
    pts = torch.as_tensor(np.asarray(keypoints[:, :2], np.float32), dtype=dtype, device=device)
    Mint, Mext, _ = calibrate_camera(pts, torch.as_tensor(vis, dtype=dtype, device=device),
                                     tuple(resolution), False)
    proj = world2img(torch.as_tensor(TABLE_POINTS, dtype=dtype, device=device), Mext, Mint)
    proj = proj.cpu().numpy()
    sel = vis > 0
    return float(np.linalg.norm(proj[sel] - keypoints[sel, :2], axis=1).mean())


def detect_left_right_swaps(keypoints: np.ndarray, resolution, margin: float = 0.5,
                            device="cuda", dtype=torch.float32):
    """(the pair indices whose swap lowers the reprojection error by more than `margin`
    px, the error as annotated). keypoints (13, 3): x, y, visibility."""
    from upliftingtabletennis_torch._device import resolve_device

    dev = resolve_device(device)
    base = _reproj_error(keypoints, resolution, dev, dtype)
    flagged = []
    for pi, (a, b) in enumerate(LEFT_RIGHT_PAIRS):
        if keypoints[a, 2] <= 0 or keypoints[b, 2] <= 0:
            continue
        swapped = keypoints.copy()
        swapped[[a, b], :2] = swapped[[b, a], :2]
        if _reproj_error(swapped, resolution, dev, dtype) + margin < base:
            flagged.append(pi)
    return flagged, base


def fix_left_right_swaps(keypoints: np.ndarray, resolution, margin: float = 0.5,
                         device="cuda", dtype=torch.float32):
    """Swap the first flagged pair until none is flagged; returns (fixed, n_swaps)."""
    fixed = keypoints.copy()
    n = 0
    for _ in range(len(LEFT_RIGHT_PAIRS)):
        flagged, _ = detect_left_right_swaps(fixed, resolution, margin, device, dtype)
        if not flagged:
            break
        a, b = LEFT_RIGHT_PAIRS[flagged[0]]
        fixed[[a, b], :2] = fixed[[b, a], :2]
        n += 1
    return fixed, n


def camera_statistics(cameras: List[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, np.ndarray]:
    """fx, fy, the camera's distance from the origin and its azimuth phi (degrees) for
    (Mint, Mext) pairs."""
    from upliftingtabletennis_torch.core.geometry import get_camera_location

    fx, fy, dist, phi = [], [], [], []
    for Mint, Mext in cameras:
        fx.append(float(np.asarray(Mint)[0, 0]))
        fy.append(float(np.asarray(Mint)[1, 1]))
        c = get_camera_location(torch.as_tensor(np.asarray(Mext), dtype=torch.float32)).numpy()
        dist.append(float(np.linalg.norm(c)))
        phi.append(float(np.rad2deg(np.arctan2(c[1], c[0]))))
    return {"fx": np.asarray(fx), "fy": np.asarray(fy), "distance": np.asarray(dist),
            "phi_deg": np.asarray(phi)}


def render_annotation_check(image, keypoints, resolution=None, out_path=None,
                            margin: float = 0.5, device="cuda"):
    """The frame (H, W, 3) with its annotated keypoints (lime, red where
    `detect_left_right_swaps` flags them, each numbered), and with at least 6 of them the
    table reprojected after a RANSAC calibration (orange crosses and wireframe); a title
    line at the top ("ANNOTATION OK" or the suspected pairs). Returns the uint8 render and
    writes it as a PNG to out_path when given."""
    from upliftingtabletennis_torch._device import resolve_device
    from upliftingtabletennis_torch.core.calibration import calibrate_from_keypoints
    from upliftingtabletennis_torch.core.geometry import (TABLE_CONNECTIONS, TABLE_POINTS,
                                                          world2img)
    from upliftingtabletennis_torch.utils.visualization import (_cross, _segment, _stamp,
                                                              draw_text)

    dev = resolve_device(device)
    img = np.array(image, np.uint8)[..., :3].copy()
    H, W = img.shape[:2]
    resolution = resolution or (W, H)
    kps = np.asarray(keypoints, np.float32)
    flagged_pairs, _ = detect_left_right_swaps(kps, resolution, margin, dev)
    swaps = [LEFT_RIGHT_PAIRS[pi] for pi in flagged_pairs]
    flagged = {i for pair in swaps for i in pair}
    scale = max(1, min(H, W) // 300)
    if (kps[:, 2] == 1).sum() >= 6:
        Mint, Mext, _ = calibrate_from_keypoints(torch.as_tensor(kps, device=dev),
                                                 tuple(resolution), use_ransac=True)
        proj = world2img(torch.as_tensor(TABLE_POINTS, device=dev), Mext, Mint).cpu().numpy()
        for a, b in TABLE_CONNECTIONS:
            _segment(img, proj[a], proj[b], 1.0, ORANGE)
        _cross(img, proj, 3 * scale, ORANGE)
    for i, (x, y, v) in enumerate(kps):
        if v != 1:
            continue
        color = RED if i in flagged else LIME
        _stamp(img, [(x, y)], 4.0 * scale, color)
        draw_text(img, str(i + 1), int(x) + 4 * scale + 2, int(y) - 9 * scale, 2 * scale, color)
    title = ("ANNOTATION OK" if not swaps else
             "SUSPECTED SWAPS " + " ".join(f"{a + 1}-{b + 1}" for a, b in swaps))
    draw_text(img, title, W // 2, 6 * scale + 4, 2 * scale, BLACK, anchor="center")
    if out_path is not None:
        from upliftingtabletennis_torch.data.png import write_png

        write_png(out_path, img)
    return img
