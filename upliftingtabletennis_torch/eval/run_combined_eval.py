"""Full-pipeline evaluation: detect, filter, uplift, calibrate.

Port of `upliftingtabletennis_tpu/eval/run_combined_eval.py`, on the port's
`TableTennisPipeline` (`run_rally`, `calibrate_camera`), with both protocols:

* TTHQ (`evaluate_rally`): per rally, both ball detectors and the agreement filter, both
  table detectors and the DBSCAN fusion, the uplifting model, and the RANSAC camera
  calibration from the fused keypoints (with at least 6 visible); reported are the
  table keypoints' reprojection error (the calibrated camera against the detections),
  the ball's (the predicted 3D track reprojected against the detected 2D track) and the
  spin against the annotated class.
* TTST (`evaluate_rally_ttst`): against the annotations, the table keypoint error (the
  fused detections against the annotated points), the ball detection error (the
  filtered detections against the annotated 2D ball) and the ball uplifting error (the
  predicted 3D track reprojected through the stored camera against the annotated 2D
  ball). Everything is at the 1920x1080 inference resolution: the stored 2560x1440
  annotations and intrinsics are rescaled (fx s, (cx + 0.5) s - 0.5).
* The pictures (`visualize_rally`): a 3D view of the predicted trajectory over the
  table's wireframe and a 2D overlay of the middle frame with the detected keypoints,
  the detected ball track and the reprojected 3D track, with the spin in the PNG's title.
  The JAX module draws them with matplotlib's Agg; the port draws the same content with
  numpy (no axes or text on the image), so that it needs no plotting package.

Rally layouts read:
  TTHQ: <root>/trajectory_XXXX/{frame_*.png} + meta.json {"fps", "spin_class"}
  TTST: <root>/trajectory_XXXX/{frames/*.png, r_img.npy, times.npy, Mint.npy, Mext.npy,
        spin_class.npy}  (the layout of the JAX package's data/extract_ttst.py)

    python -m upliftingtabletennis_torch.eval.run_combined_eval --dataset tthq \\
        --data_root <root> [--checkpoints '{"ball_main": ...}'] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from upliftingtabletennis_torch.pipeline.interface import HEIGHT, WIDTH

__all__ = ["TTST_SRC_RES", "TOPSPIN_CLASS", "BACKSPIN_CLASS", "SpinCounts", "evaluate_rally",
           "evaluate_rally_ttst", "render_rally_3d", "render_rally_overlay", "visualize_rally",
           "main"]

TTST_SRC_RES = (2560, 1440)  # the annotations' frame
TOPSPIN_CLASS, BACKSPIN_CLASS = 1, 2


class SpinCounts:
    """TP/TN/FP/FN of topspin against backspin over rallies."""

    def __init__(self):
        self.tp = self.tn = self.fp = self.fn = 0

    def update(self, spin_pred, spin_class):
        if spin_pred is None or spin_class not in (TOPSPIN_CLASS, BACKSPIN_CLASS):
            return
        pred_top = spin_pred[1] > 0
        if spin_class == TOPSPIN_CLASS:
            self.tp += int(pred_top)
            self.fn += int(not pred_top)
        else:
            self.tn += int(not pred_top)
            self.fp += int(pred_top)

    def metrics(self):
        total = max(self.tp + self.tn + self.fp + self.fn, 1)
        f1p = 2 * self.tp / max(2 * self.tp + self.fp + self.fn, 1)
        f1m = 2 * self.tn / max(2 * self.tn + self.fn + self.fp, 1)
        return {"accuracy": (self.tp + self.tn) / total, "macro_f1": (f1p + f1m) / 2}


def _reproject(pos3d, Mint, Mext):
    """World points (N, 3) -> pixels (N, 2) through (Mint, Mext), in f32 on the CPU."""
    from upliftingtabletennis_torch.core.geometry import world2img

    return world2img(*(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                       for a in (pos3d, Mext, Mint))).numpy()


def evaluate_rally(pipeline, frames, fps):
    """The TTHQ protocol's numbers of one rally: {"spin", "pos3d", "n_ball",
    "table_reproj_px", "ball_reproj_px"} (NaN where the camera or the track is
    missing)."""
    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS

    out = pipeline.run_rally(frames, fps)
    ball, table, spin, pos3d = out["ball"], out["table"], out["spin"], out["pos3d"]

    ball_reproj_err = table_reproj_err = np.nan
    if int((table[:, 2] == 1).sum()) >= 6:
        Mint, Mext, _ = pipeline.calibrate_camera(table)
        proj_table = _reproject(TABLE_POINTS, Mint, Mext)
        vis = table[:, 2] == 1
        table_reproj_err = float(np.linalg.norm(proj_table[vis] - table[vis, :2], axis=1).mean())
        if pos3d is not None and len(pos3d):
            proj_ball = _reproject(pos3d, Mint, Mext)
            n = min(len(proj_ball), len(ball))
            ball_reproj_err = float(np.linalg.norm(proj_ball[:n] - ball[:n], axis=1).mean())
    return {"spin": spin, "pos3d": pos3d, "n_ball": len(ball),
            "table_reproj_px": table_reproj_err, "ball_reproj_px": ball_reproj_err}


def evaluate_rally_ttst(pipeline, frames, ann, frame_offset: int = 1):
    """The TTST protocol's numbers of one rally: {"spin", "pos3d", "table_px",
    "ball_detection_px", "ball_uplifting_px"} (NaN where nothing is left to score).

    ann: r_img (T, 2) px at 2560x1440, times (T,), Mint (3, 3) at 2560x1440, Mext (4, 4),
    spin_class, and optionally table_img (13, 2) px at 2560x1440. frames[i +
    frame_offset] is the frame of annotation i (the extractor pads one frame at each
    end)."""
    from upliftingtabletennis_torch.core.geometry import rescale_intrinsics

    times_ann = np.asarray(ann["times"], np.float64)
    fps = 1.0 / float(times_ann[1] - times_ann[0])
    scale = np.array([WIDTH / TTST_SRC_RES[0], HEIGHT / TTST_SRC_RES[1]])
    r_img = np.asarray(ann["r_img"], np.float64) * scale
    Mint = rescale_intrinsics(torch.as_tensor(np.asarray(ann["Mint"]), dtype=torch.float32),
                              TTST_SRC_RES, (WIDTH, HEIGHT)).numpy()
    Mext = np.asarray(ann["Mext"], np.float64)

    out = pipeline.run_rally(frames, fps)
    ball, valid_idx, table = out["ball"], out["valid_idx"], out["table"]
    spin, pos3d = out["spin"], out["pos3d"]

    # interior frame k (centre frames[k + 1]) is annotation k + frame_offset - 1; the
    # detections with a matching annotation are scored
    ann_idx = valid_idx + frame_offset - 1
    keep = (ann_idx >= 0) & (ann_idx < len(r_img))
    det = ball[keep]
    gt = r_img[ann_idx[keep]]
    err_ball_det = float(np.linalg.norm(det - gt, axis=1).mean()) if len(det) else np.nan

    # the table: the fused detections against the annotated points (all visible)
    err_table = np.nan
    if "table_img" in ann:
        t_gt = np.asarray(ann["table_img"], np.float64) * scale
        vis = table[:, 2] == 1
        if vis.any():
            err_table = float(np.linalg.norm(table[vis, :2] - t_gt[vis], axis=1).mean())

    # pos3d's rows are the filtered ball rows (possibly cut to the 50-token window)
    err_ball_upl = np.nan
    if pos3d is not None and len(pos3d):
        proj = _reproject(pos3d, Mint, Mext)[keep[:len(pos3d)]]
        n = min(len(proj), len(gt))
        if n:
            err_ball_upl = float(np.linalg.norm(proj[:n] - gt[:n], axis=1).mean())
    return {"spin": spin, "pos3d": pos3d, "table_px": err_table,
            "ball_detection_px": err_ball_det, "ball_uplifting_px": err_ball_upl}


# --- pictures ------------------------------------------------------------------------
# drawn with numpy and written by data/png.py: the port needs no plotting package
LIME, ORANGE, GREEN, BLACK, WHITE = (0, 255, 0), (255, 165, 0), (0, 128, 0), (0, 0, 0), 255
VIEW_ELEV_DEG, VIEW_AZIM_DEG = 20.0, 130.0  # the 3D view of the JAX module's plot


def _stamp(img, pts, radius: float, color) -> None:
    """Discs of `radius` px centred at pts (N, 2) (x, y) on img (H, W, 3) uint8, in place;
    what falls outside the image is left out."""
    H, W = img.shape[:2]
    r = int(np.ceil(radius))
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    disc = ox ** 2 + oy ** 2 <= radius ** 2
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    pts = pts[np.isfinite(pts).all(1) & (np.abs(pts) < 1e6).all(1)]
    cx = np.rint(pts[:, :1]).astype(np.int64) + ox[disc][None]
    cy = np.rint(pts[:, 1:]).astype(np.int64) + oy[disc][None]
    ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    img[cy[ok], cx[ok]] = color


def _polyline(img, pts, width: float, color) -> None:
    """The segments between consecutive pts (N, 2), `width` px wide."""
    pts = np.asarray(pts, np.float64)
    for p0, p1 in zip(pts[:-1], pts[1:]):
        t = np.linspace(0.0, 1.0, max(int(np.ceil(2 * np.linalg.norm(p1 - p0))), 1) + 1)
        _stamp(img, p0 + t[:, None] * (p1 - p0), width / 2, color)


def _spin_title(spin_pred, spin_gt: int) -> str:
    pred = "Topspin" if spin_pred[1] > 0 else "Backspin"
    gt = {TOPSPIN_CLASS: "Topspin", BACKSPIN_CLASS: "Backspin"}.get(spin_gt, "Unknown")
    return f"Predicted Spin: {pred} {spin_pred[1] / (2 * np.pi):.1f}Hz , GT: {gt}"


def render_rally_3d(pos3d, out_path: str, size: int = 800):
    """The 3D trajectory (orange) over the table's wireframe (black) and keypoints (green),
    seen orthographically from elevation 20 and azimuth 130 degrees with equal axes, to a
    size x size PNG."""
    from upliftingtabletennis_torch.core.geometry import TABLE_CONNECTIONS, TABLE_POINTS
    from upliftingtabletennis_torch.data.png import write_png

    tp = np.asarray(TABLE_POINTS, np.float64)
    pos3d = np.asarray(pos3d, np.float64)
    pts = np.concatenate([pos3d, tp])
    mid = 0.5 * (pts.min(0) + pts.max(0))
    radius = max(0.5 * float((pts.max(0) - pts.min(0)).max()), 1e-6)
    az, el = np.deg2rad(VIEW_AZIM_DEG), np.deg2rad(VIEW_ELEV_DEG)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])
    scale = 0.45 * size / (radius * np.sqrt(3.0))  # the equal-axes cube fits the canvas

    def px(p):
        q = p - mid
        return np.stack([size / 2 + scale * (q @ right), size / 2 - scale * (q @ up)], -1)

    img = np.full((size, size, 3), WHITE, np.uint8)
    for a, b in TABLE_CONNECTIONS:
        _polyline(img, px(tp[[a, b]]), 2.0, BLACK)
    _stamp(img, px(tp), 5.0, GREEN)
    _polyline(img, px(pos3d), 4.0, ORANGE)
    write_png(out_path, img, {"Title": "Predicted Ball Trajectory"})


def render_rally_overlay(frame, table, ball, pos3d, Mint, Mext, out_path: str,
                         spin_pred=None, spin_gt: int = 0):
    """The middle frame with the detected keypoints (green), the detected ball track
    (green) and the reprojected 3D track (orange), to a PNG at the frame's size; the spin,
    predicted and annotated, in its title (a tEXt chunk)."""
    from upliftingtabletennis_torch.data.png import write_png

    img = np.array(frame, np.uint8)[..., :3]
    sx, sy = img.shape[1] / WIDTH, img.shape[0] / HEIGHT
    table = np.asarray(table)
    vis = table[:, 2] == 1
    _stamp(img, table[vis, :2] * (sx, sy), 5.0, LIME)
    ball = np.asarray(ball)
    if len(ball):
        _stamp(img, ball[:, :2] * (sx, sy), 3.0, LIME)
    if pos3d is not None and len(pos3d) and Mint is not None:
        proj = _reproject(pos3d, Mint, Mext)
        ok = (proj[:, 0] >= 0) & (proj[:, 0] < WIDTH) & (proj[:, 1] >= 0) & (proj[:, 1] < HEIGHT)
        _stamp(img, proj[ok] * (sx, sy), 2.0, ORANGE)
    write_png(out_path, img, {"Title": _spin_title(spin_pred, spin_gt)}
              if spin_pred is not None else None)


def visualize_rally(pipeline, frames, fps, out_dir: str, name: str, spin_gt: int = 0):
    """Run the pipeline on one rally and write <name>_3d.png (when a 3D track exists) and
    <name>_2d.png; returns the `run_rally` output."""
    os.makedirs(out_dir, exist_ok=True)
    out = pipeline.run_rally(frames, fps)
    Mint = Mext = None
    if int((out["table"][:, 2] == 1).sum()) >= 6:
        Mint, Mext, _ = pipeline.calibrate_camera(out["table"])
    if out["pos3d"] is not None and len(out["pos3d"]):
        render_rally_3d(out["pos3d"], os.path.join(out_dir, f"{name}_3d.png"))
    render_rally_overlay(frames[len(frames) // 2], out["table"], out["ball"], out["pos3d"],
                         Mint, Mext, os.path.join(out_dir, f"{name}_2d.png"), out["spin"],
                         spin_gt)
    return out


# --- CLI -----------------------------------------------------------------------------
def _load_frames(paths):
    from upliftingtabletennis_torch.data.png import read_png

    frames = []
    for f in paths:  # RGB: grey repeated, alpha dropped
        img = read_png(f)
        frames.append(np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3])
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=["tthq", "ttst"], default="tthq")
    p.add_argument("--data_root", required=True)
    p.add_argument("--checkpoints", type=str, default=None,
                   help="a JSON dict of port checkpoint paths (ball_main, ball_aux, "
                        "table_main, table_aux, uplifting)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--visualize_dir", type=str, default=None,
                   help="write <traj>_3d.png / <traj>_2d.png here")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

    ck = json.loads(args.checkpoints) if args.checkpoints else None
    pipeline = TableTennisPipeline(ck, device=args.device)

    traj_dirs = sorted(glob.glob(os.path.join(args.data_root, "trajectory_*")))
    if args.limit:
        traj_dirs = traj_dirs[:args.limit]

    spin = SpinCounts()
    errs: dict = {}
    for d in traj_dirs:
        name = os.path.basename(d)
        if args.dataset == "tthq":
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            frames = _load_frames(sorted(glob.glob(os.path.join(d, "frame_*.png"))))
            out = evaluate_rally(pipeline, frames, meta["fps"])
            keys = ("table_reproj_px", "ball_reproj_px")
            fps, spin_gt = meta["fps"], meta.get("spin_class", 0)
        else:
            frames = _load_frames(sorted(glob.glob(os.path.join(d, "frames", "*.png"))))
            ann = {k: np.load(os.path.join(d, f"{k}.npy"))
                   for k in ("r_img", "times", "Mint", "Mext", "spin_class")}
            out = evaluate_rally_ttst(pipeline, frames, ann)
            keys = ("table_px", "ball_detection_px", "ball_uplifting_px")
            fps = 1.0 / float(ann["times"][1] - ann["times"][0])
            spin_gt = int(ann["spin_class"])
        for k in keys:
            if np.isfinite(out[k]):
                errs.setdefault(k, []).append(out[k])
        spin.update(out["spin"], spin_gt)
        if args.visualize_dir:
            visualize_rally(pipeline, frames, fps, args.visualize_dir, name, spin_gt)

    for k, v in errs.items():
        print(f"{k}: {np.mean(v):.2f} ± {np.std(v):.2f} px  (n={len(v)})")
    m = spin.metrics()
    print(f"spin acc: {m['accuracy']:.4f}  macro-F1: {m['macro_f1']:.4f}")
    return {"errors": {k: float(np.mean(v)) for k, v in errs.items()}, "n": len(traj_dirs),
            **m}


if __name__ == "__main__":
    main()
