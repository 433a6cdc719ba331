"""Pose and keypoint skeleton drawing, and the padding of frames to an aspect ratio.

Port of `upliftingtabletennis_tpu/utils/pose_viz.py`: the skeleton registry (COCO-17 and
MPII-16 built in, others registered at run time), points as filled discs in one palette
colour per joint, limbs as 2 px segments in one palette colour per person, points as rows
of (y, x, confidence). The JAX module draws with OpenCV and samples matplotlib's listed
colormaps; here the palettes are constant tables of those samples (BGR, as OpenCV takes
them) and the drawing is numpy, after OpenCV's LINE_8 rules: a filled disc by its
midpoint circle (`cv2.circle(..., -1)`, pixel for pixel), a 2 px segment by its thick
line, a rectangle filled scanline by scanline at 1/65536 px with round caps
(`cv2.line(..., 2)`; about 0.2% of a limb's pixels, at its corners, come out
differently).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["joints_dict", "register_skeleton", "draw_points", "draw_skeleton",
           "draw_points_and_skeleton", "pad_image", "PALETTES"]

_SKELETONS: Dict[str, dict] = {
    "coco": {
        "keypoints": {
            0: "nose", 1: "left_eye", 2: "right_eye", 3: "left_ear",
            4: "right_ear", 5: "left_shoulder", 6: "right_shoulder",
            7: "left_elbow", 8: "right_elbow", 9: "left_wrist",
            10: "right_wrist", 11: "left_hip", 12: "right_hip",
            13: "left_knee", 14: "right_knee", 15: "left_ankle",
            16: "right_ankle",
        },
        "skeleton": [
            [15, 13], [13, 11], [16, 14], [14, 12], [11, 12], [5, 11],
            [6, 12], [5, 6], [5, 7], [6, 8], [7, 9], [8, 10], [1, 2],
            [0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6],
        ],
    },
    "mpii": {
        "keypoints": {
            0: "right_ankle", 1: "right_knee", 2: "right_hip", 3: "left_hip",
            4: "left_knee", 5: "left_ankle", 6: "pelvis", 7: "thorax",
            8: "upper_neck", 9: "head_top", 10: "right_wrist",
            11: "right_elbow", 12: "right_shoulder", 13: "left_shoulder",
            14: "left_elbow", 15: "left_wrist",
        },
        "skeleton": [
            [0, 1], [1, 2], [2, 6], [3, 6], [3, 4], [4, 5], [6, 7], [7, 8],
            [8, 9], [10, 11], [11, 12], [12, 7], [13, 7], [13, 14], [14, 15],
        ],
    },
}

# matplotlib's listed colormaps, every colour, rounded to 0-255 and given as BGR
PALETTES: Dict[str, List[Tuple[int, int, int]]] = {
    "tab20": [(180, 119, 31), (232, 199, 174), (14, 127, 255), (120, 187, 255), (44, 160, 44),
              (138, 223, 152), (40, 39, 214), (150, 152, 255), (189, 103, 148),
              (213, 176, 197), (75, 86, 140), (148, 156, 196), (194, 119, 227),
              (210, 182, 247), (127, 127, 127), (199, 199, 199), (34, 189, 188),
              (141, 219, 219), (207, 190, 23), (229, 218, 158)],
    "tab10": [(180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
              (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188),
              (207, 190, 23)],
    "Set1": [(28, 26, 228), (184, 126, 55), (74, 175, 77), (163, 78, 152), (0, 127, 255),
             (51, 255, 255), (40, 86, 166), (191, 129, 247), (153, 153, 153)],
    "Set2": [(165, 194, 102), (98, 141, 252), (203, 160, 141), (195, 138, 231),
             (84, 216, 166), (47, 217, 255), (148, 196, 229), (179, 179, 179)],
}


def register_skeleton(name: str, keypoints: Dict[int, str],
                      skeleton: Sequence[Sequence[int]]) -> None:
    """Register another dataset's skeleton (ap10k, aic, ...)."""
    _SKELETONS[name] = {"keypoints": dict(keypoints), "skeleton": [list(p) for p in skeleton]}


def joints_dict() -> Dict[str, dict]:
    """name -> {"keypoints": {index: name}, "skeleton": [[a, b], ...]}."""
    return _SKELETONS


def _palette(name: str, samples: int) -> List[Tuple[int, int, int]]:
    """A listed colormap's colours (BGR); `samples` is ignored, as matplotlib's listed maps
    give every colour whatever the count asked for."""
    del samples
    if name not in PALETTES:
        raise KeyError(f"palette {name!r}: the port has {sorted(PALETTES)}")
    return PALETTES[name]


def _hline(img, y: int, x0: int, x1: int, color) -> None:
    H, W = img.shape[:2]
    if 0 <= y < H and x1 >= 0 and x0 < W:
        img[y, max(x0, 0):min(x1, W - 1) + 1] = color


def _filled_circle(img, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled midpoint circle (`Circle` with fill, LINE_8, no shift)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


XY_SHIFT = 16  # OpenCV's subpixel bits in its thick-line drawing
XY_ONE = 1 << XY_SHIFT


def _put(img, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _subpixel_line(img, p1, p2, color) -> None:
    """A one-pixel line between points in XY_ONE units, stepped along its major axis."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx < 0) if major_x else (dy < 0):  # walk in the positive direction
        x1, x2, y1, y2, dx, dy = x2, x1, y2, y1, -dx, -dy
    if major_x:
        step = int((dy << XY_SHIFT) / (abs(dx) | 1))
        count = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    else:
        step = int((dx << XY_SHIFT) / (abs(dy) | 1))
        count = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if major_x:
        x = x1 >> XY_SHIFT
        for _ in range(count + 1):
            _put(img, x, y1 >> XY_SHIFT, color)
            x += 1
            y1 += step
    else:
        y = y1 >> XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y, color)
            x1 += step
            y += 1


def _fill_convex(img, v, color) -> None:
    """OpenCV's scanline fill of a convex polygon v (points in XY_ONE units, LINE_8): its
    outline, then per row the span between its two edges, each end rounded."""
    H, W = img.shape[:2]
    n, half = len(v), XY_ONE >> 1
    for i in range(n):
        _subpixel_line(img, v[i - 1], v[i], color)
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    xmin = (min(p[0] for p in v) + half) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + half) >> XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edges = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    left_to_scan, y = n, ymin
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                left_to_scan -= 1
                if left_to_scan < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:  # the edge idx0 -> idx spans this row: x per row, C rounding
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, dx=int(((xe - xs) * 2 + (ty - y)) / (2 * (ty - y))),
                             x=xs, idx=idx)
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if left_to_scan < 0:
            return
        if y >= 0:
            lo, hi = sorted((edges[0]["x"], edges[1]["x"]))
            _hline(img, y, (lo + half) >> XY_SHIFT, (hi + half) >> XY_SHIFT, color)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            return


def _thick_line(img, p0, p1, color, thickness: int = 2) -> None:
    """OpenCV's thick LINE_8 segment between integer points p0, p1 (x, y): the rectangle of
    half-width thickness / 2 filled (`_fill_convex`), and round caps of radius
    thickness / 2 (`_filled_circle`)."""
    x0, y0, x1, y1 = (c << XY_SHIFT for c in (*p0, *p1))
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r2 = dx * dx + dy * dy
    half_width = thickness << (XY_SHIFT - 1)
    if r2 > np.finfo(np.float64).eps:
        r = (half_width + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy), (x1 - ox, y1 - oy),
                           (x1 + ox, y1 + oy)], color)
    for cx, cy in (p0, p1):
        _filled_circle(img, cx, cy, (half_width + (XY_ONE >> 1)) >> XY_SHIFT, color)


def draw_points(image: np.ndarray, points: np.ndarray, color_palette: str = "tab20",
                palette_samples: int = 16, confidence_threshold: float = 0.5) -> np.ndarray:
    """(y, x, conf) points above the threshold as filled discs of radius
    max(1, min(H, W) // 150), colour i of the palette for joint i; in place, returned."""
    colors = _palette(color_palette, palette_samples)
    radius = max(1, min(image.shape[:2]) // 150)
    for i, pt in enumerate(np.asarray(points)):
        if pt[2] > confidence_threshold:
            _filled_circle(image, int(pt[1]), int(pt[0]), radius, colors[i % len(colors)])
    return image


def draw_skeleton(image: np.ndarray, points: np.ndarray, skeleton: Sequence[Sequence[int]],
                  color_palette: str = "Set2", palette_samples: int = 8, person_index: int = 0,
                  confidence_threshold: float = 0.5) -> np.ndarray:
    """Limbs between joints both above the threshold, 2 px wide, in the person's palette
    colour; in place, returned."""
    colors = _palette(color_palette, palette_samples)
    color = colors[person_index % len(colors)]
    pts = np.asarray(points)
    for a, b in skeleton:
        p1, p2 = pts[a], pts[b]
        if p1[2] > confidence_threshold and p2[2] > confidence_threshold:
            _thick_line(image, (int(p1[1]), int(p1[0])), (int(p2[1]), int(p2[0])), color)
    return image


def draw_points_and_skeleton(image: np.ndarray, points: np.ndarray,
                             skeleton: Sequence[Sequence[int]],
                             points_color_palette: str = "tab20",
                             points_palette_samples: int = 16,
                             skeleton_color_palette: str = "Set2",
                             skeleton_palette_samples: int = 8, person_index: int = 0,
                             confidence_threshold: float = 0.5) -> np.ndarray:
    """The skeleton, then the points over it."""
    image = draw_skeleton(image, points, skeleton, color_palette=skeleton_color_palette,
                          palette_samples=skeleton_palette_samples, person_index=person_index,
                          confidence_threshold=confidence_threshold)
    return draw_points(image, points, color_palette=points_color_palette,
                       palette_samples=points_palette_samples,
                       confidence_threshold=confidence_threshold)


def pad_image(image: np.ndarray, aspect_ratio: float) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad to the aspect ratio (W / H), centred; returns the padded image and the
    (left, top) offset."""
    h, w = image.shape[:2]
    left = top = 0
    if w / h < aspect_ratio:
        target_w = int(aspect_ratio * h)
        left = (target_w - w) // 2
        pads = ((0, 0), (left, target_w - w - left)) + ((0, 0),) * (image.ndim - 2)
    else:
        target_h = int(w / aspect_ratio)
        top = (target_h - h) // 2
        pads = ((top, target_h - h - top), (0, 0)) + ((0, 0),) * (image.ndim - 2)
    return np.pad(image, pads, mode="constant"), (left, top)
