"""Figures and summaries of training and validation, drawn with numpy.

Port of `upliftingtabletennis_tpu/utils/visualization.py`: the sign-confusion matrix of
the uplifting trainer's validation (every 10 epochs), the ROC curve and the missortings of
its TTST validation, and the heatmap overlay of the detector trainer's validation, each an
(H, W, 3) uint8 array for `SummaryWriter.add_image(..., dataformats="HWC")`. The JAX
module renders with matplotlib, which the port does not need: the figures here are drawn
in numpy at the JAX figures' sizes (220x220, 500x400, 800x450), with the same colours and
marks, the counts written in a small bitmap font. `roc_curve_points`, `roc_auc` and
`count_missortings` are the JAX functions' numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["confusion_matrix_image", "roc_curve_points", "roc_auc", "roc_curve_image",
           "count_missortings", "heatmap_overlay_image", "draw_text"]

WHITE, BLACK, GREY = (255, 255, 255), (0, 0, 0), (128, 128, 128)
BLUE, LIME, ORANGE = (0, 0, 255), (0, 255, 0), (255, 165, 0)
GRID = (230, 230, 230)
# matplotlib's "Blues" at 0 and 1, and "Reds" at 1: the ends of the ramps the JAX figures use
BLUES_LO, BLUES_HI = np.array([247, 251, 255.0]), np.array([8, 48, 107.0])
REDS_HI = np.array([103, 0, 13.0])
HEAT_ALPHA = 0.45

# a 3x5 font: rows top to bottom, '#' set
_FONT = {
    "0": ("###", "#.#", "#.#", "#.#", "###"), "1": (".#.", "##.", ".#.", ".#.", "###"),
    "2": ("###", "..#", "###", "#..", "###"), "3": ("###", "..#", ".##", "..#", "###"),
    "4": ("#.#", "#.#", "###", "..#", "..#"), "5": ("###", "#..", "###", "..#", "###"),
    "6": ("###", "#..", "###", "#.#", "###"), "7": ("###", "..#", ".#.", ".#.", ".#."),
    "8": ("###", "#.#", "###", "#.#", "###"), "9": ("###", "#.#", "###", "..#", "###"),
    ".": ("...", "...", "...", "...", ".#."), "-": ("...", "...", "###", "...", "..."),
    "+": ("...", ".#.", "###", ".#.", "..."), "=": ("...", "###", "...", "###", "..."),
    " ": ("...", "...", "...", "...", "..."), "A": (".#.", "#.#", "###", "#.#", "#.#"),
    "C": ("###", "#..", "#..", "#..", "###"), "D": ("##.", "#.#", "#.#", "#.#", "##."),
    "E": ("###", "#..", "##.", "#..", "###"), "G": ("###", "#..", "#.#", "#.#", "###"),
    "N": ("#.#", "###", "###", "###", "#.#"), "P": ("###", "#.#", "###", "#..", "#.."),
    "R": ("##.", "#.#", "##.", "#.#", "#.#"), "T": ("###", ".#.", ".#.", ".#.", ".#."),
    "U": ("#.#", "#.#", "#.#", "#.#", "###"), "X": ("#.#", "#.#", ".#.", "#.#", "#.#"),
    "Y": ("#.#", "#.#", ".#.", ".#.", ".#."), "Z": ("###", "..#", ".#.", "#..", "###"),
    "B": ("##.", "#.#", "##.", "#.#", "##."), "F": ("###", "#..", "##.", "#..", "#.."),
    "H": ("#.#", "#.#", "###", "#.#", "#.#"), "I": ("###", ".#.", ".#.", ".#.", "###"),
    "J": ("..#", "..#", "..#", "#.#", "###"), "K": ("#.#", "##.", "#..", "##.", "#.#"),
    "L": ("#..", "#..", "#..", "#..", "###"), "M": ("#.#", "###", "###", "#.#", "#.#"),
    "O": ("###", "#.#", "#.#", "#.#", "###"), "Q": ("###", "#.#", "#.#", "###", "..#"),
    "S": ("###", "#..", "###", "..#", "###"), "V": ("#.#", "#.#", "#.#", "#.#", ".#."),
    "W": ("#.#", "#.#", "###", "###", "#.#"), "_": ("...", "...", "...", "...", "###"),
}


def draw_text(img: np.ndarray, text: str, x: int, y: int, scale: int, color,
              anchor: str = "topleft") -> None:
    """`text` in the 3x5 font at `scale` px per dot, in place; anchor "topleft" or
    "center" at (x, y). Characters outside the font are drawn as blanks."""
    w, h = (4 * len(text) - 1) * scale, 5 * scale
    if anchor == "center":
        x, y = x - w // 2, y - h // 2
    H, W = img.shape[:2]
    for i, ch in enumerate(text.upper()):
        rows = _FONT.get(ch, _FONT[" "])
        for r, row in enumerate(rows):
            for c, bit in enumerate(row):
                if bit != "#":
                    continue
                y0, x0 = y + r * scale, x + (4 * i + c) * scale
                img[max(y0, 0):min(y0 + scale, H), max(x0, 0):min(x0 + scale, W)] = color


def _segment(img, p0, p1, width: float, color, dash: Optional[float] = None) -> None:
    """A segment from p0 to p1 (x, y), `width` px wide; dashed with period 2 * dash."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    n = max(int(np.ceil(2 * np.linalg.norm(p1 - p0))), 1) + 1
    t = np.linspace(0.0, 1.0, n)
    pts = p0 + t[:, None] * (p1 - p0)
    if dash:
        pts = pts[(np.floor(t * np.linalg.norm(p1 - p0) / dash) % 2) == 0]
    _stamp(img, pts, width / 2, color)


def _stamp(img, pts, radius: float, color) -> None:
    """Discs of `radius` px at pts (N, 2) (x, y), in place, clipped to the image."""
    H, W = img.shape[:2]
    r = int(np.ceil(radius))
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    disc = ox ** 2 + oy ** 2 <= max(radius, 0.5) ** 2
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    pts = pts[np.isfinite(pts).all(1)]
    cx = np.rint(pts[:, :1]).astype(np.int64) + ox[disc][None]
    cy = np.rint(pts[:, 1:]).astype(np.int64) + oy[disc][None]
    ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    img[cy[ok], cx[ok]] = color


def _cross(img, pts, half: int, color) -> None:
    """An 'x' marker of half-size `half` px at each of pts (N, 2)."""
    for x, y in np.asarray(pts, np.float64).reshape(-1, 2):
        _segment(img, (x - half, y - half), (x + half, y + half), 2.0, color)
        _segment(img, (x - half, y + half), (x + half, y - half), 2.0, color)


def confusion_matrix_image(tp: int, tn: int, fp: int, fn: int,
                           title: Optional[str] = "Confusion Matrix") -> np.ndarray:
    """The 2x2 sign-confusion matrix [[tp, fn], [fp, tn]] (rows GT +/-, columns Pred +/-)
    as a 220x220 image: each cell shaded on the Blues ramp by its count over the largest,
    its count written in it (white on the darker half); the title at the top."""
    size, top, left, cell = 220, 40, 50, 80
    img = np.full((size, size, 3), 255, np.uint8)
    cm = np.array([[tp, fn], [fp, tn]], np.float64)
    peak = cm.max()
    for i in range(2):
        for j in range(2):
            v = cm[i, j] / peak if peak > 0 else 0.0
            shade = np.rint(BLUES_LO + v * (BLUES_HI - BLUES_LO)).astype(np.uint8)
            y0, x0 = top + i * cell, left + j * cell
            img[y0:y0 + cell, x0:x0 + cell] = shade
            draw_text(img, str(int(cm[i, j])), x0 + cell // 2, y0 + cell // 2, 3,
                      WHITE if v > 0.5 else BLACK, anchor="center")
    for j, label in enumerate(("PRED+", "PRED-")):
        draw_text(img, label, left + j * cell + cell // 2, top - 12, 2, BLACK, anchor="center")
    for i, label in enumerate(("GT+", "GT-")):
        draw_text(img, label, left // 2, top + i * cell + cell // 2, 2, BLACK, anchor="center")
    if title:
        draw_text(img, title, size // 2, 8, 2, BLACK, anchor="center")
    return img


def roc_curve_points(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) of scores for binary labels: the scores sorted descending
    and the threshold swept over their distinct values, (0, 0, inf) first."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores)
    labels = labels[order]
    scores = scores[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    distinct = np.nonzero(np.diff(scores))[0]  # the last index of each distinct score
    idx = np.concatenate([distinct, [len(scores) - 1]])
    tpr = tps[idx] / max(tps[-1], 1)
    fpr = fps[idx] / max(fps[-1], 1)
    return (np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr]),
            np.concatenate([[np.inf], scores[idx]]))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """The trapezoidal area under `roc_curve_points`."""
    fpr, tpr, _ = roc_curve_points(labels, scores)
    return float(np.trapezoid(tpr, fpr))


def roc_curve_image(labels: np.ndarray, scores: np.ndarray,
                    show_thresholds: bool = False) -> np.ndarray:
    """The ROC curve (blue) over the chance diagonal (grey, dashed) and a grid of tenths,
    false positive rate across and true positive rate up, as a 500x400 image, the AUC
    written at the lower right. show_thresholds marks each threshold's point."""
    W, H, left, right, top, bottom = 500, 400, 50, 20, 20, 40
    img = np.full((H, W, 3), 255, np.uint8)
    pw, ph = W - left - right, H - top - bottom

    def px(f, t):
        return np.stack([left + np.asarray(f) * pw, top + (1 - np.asarray(t)) * ph], -1)

    for k in range(11):
        _segment(img, px(k / 10, 0), px(k / 10, 1), 1.0, GRID)
        _segment(img, px(0, k / 10), px(1, k / 10), 1.0, GRID)
    for a, b in (((0, 0), (1, 0)), ((0, 0), (0, 1)), ((1, 0), (1, 1)), ((0, 1), (1, 1))):
        _segment(img, px(*a), px(*b), 1.0, BLACK)
    _segment(img, px(0, 0), px(1, 1), 1.5, GREY, dash=6.0)
    fpr, tpr, _ = roc_curve_points(labels, scores)
    pts = px(fpr, tpr)
    for p0, p1 in zip(pts[:-1], pts[1:]):
        _segment(img, p0, p1, 2.0, BLUE)
    if show_thresholds:
        _stamp(img, pts[1:], 3.0, BLUE)
    draw_text(img, f"AUC={np.trapezoid(tpr, fpr):.3f}", W - right - 130, H - bottom - 30, 3,
              BLUE)
    for k in (0, 5, 10):
        draw_text(img, f"{k / 10:.1f}", int(px(k / 10, 0)[0]), H - bottom + 14, 2, BLACK,
                  anchor="center")
        draw_text(img, f"{k / 10:.1f}", left - 22, int(px(0, k / 10)[1]), 2, BLACK,
                  anchor="center")
    return img


def count_missortings(labels: np.ndarray, scores: np.ndarray) -> Tuple[int, float]:
    """The fewest misclassifications over all thresholds (predict positive at score >=
    threshold) and the optimal threshold, the one closest to 0 among ties."""
    labels = np.asarray(labels).astype(int)
    scores = np.asarray(scores, np.float64)
    thresholds = np.sort(np.unique(scores))[::-1]
    preds = scores[None, :] >= thresholds[:, None]  # (thresholds, N)
    miss = np.sum(preds != labels[None, :].astype(bool), axis=1)
    best = miss.min()
    cand = thresholds[miss == best]
    return int(best), float(cand[np.argmin(np.abs(cand))])


def heatmap_overlay_image(image: np.ndarray, pred_heat: np.ndarray,
                          gt_coords: Optional[np.ndarray] = None,
                          pred_coords: Optional[np.ndarray] = None) -> np.ndarray:
    """The validation overlay as an 800x450 image: the frame, the predicted heatmap on the
    Reds ramp at alpha 0.45 (its maximum over channels, scaled by its peak, resized to the
    frame by the JAX function's nearest rows and columns), the ground-truth keypoints as
    lime crosses and the extracted peaks as orange ones.

    image (H, W, 3) in [0, 255] (normalised inputs de-normalised by the caller);
    pred_heat (h, w) or (P, h, w); coords (P, >= 2) in image pixels, a third column the
    visibility (only 1 is drawn)."""
    img = np.clip(np.asarray(image, np.float32), 0, 255).astype(np.uint8)
    H, W = img.shape[:2]
    heat = np.asarray(pred_heat, np.float32)
    if heat.ndim == 3:
        heat = heat.max(axis=0)
    ys = np.linspace(0, heat.shape[0] - 1, H)
    xs = np.linspace(0, heat.shape[1] - 1, W)
    heat = heat[np.clip(ys.astype(int), 0, None)][:, np.clip(xs.astype(int), 0, None)]
    heat = np.clip(heat / max(float(heat.max()), 1e-6), 0, 1)
    red = np.array(WHITE, np.float64) + heat[..., None] * (REDS_HI - np.array(WHITE, np.float64))
    blend = (1 - HEAT_ALPHA) * img + HEAT_ALPHA * red
    # the figure's size: the frame scaled to fit 800x450, centred on white
    OW, OH = 800, 450
    s = min(OW / W, OH / H)
    nw, nh = max(int(round(W * s)), 1), max(int(round(H * s)), 1)
    rows = np.minimum((np.arange(nh) / s).astype(int), H - 1)
    cols = np.minimum((np.arange(nw) / s).astype(int), W - 1)
    out = np.full((OH, OW, 3), 255, np.uint8)
    oy, ox = (OH - nh) // 2, (OW - nw) // 2
    out[oy:oy + nh, ox:ox + nw] = np.rint(blend[rows][:, cols]).astype(np.uint8)
    for coords, color in ((gt_coords, LIME), (pred_coords, ORANGE)):
        if coords is None:
            continue
        c = np.asarray(coords, np.float64)
        vis = c[:, 2] == 1 if c.shape[1] > 2 else np.ones(len(c), bool)
        _cross(out, c[vis, :2] * s + (ox, oy), 5, color)
    return out
