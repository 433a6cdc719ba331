"""Detection evaluation CLI: PCK@{2,5,10,20} px on the TTHQ test split.

Port of `upliftingtabletennis_tpu/eval/run_detection_eval.py`. A checkpoint is a port
checkpoint (`utils/checkpoint.py`) whose metadata names the model, its input frames and
the input resolution it was trained at (`resolution`, or the closed loop's `render_res`,
which the JAX module does not read). The metrics are measured at
1920x1080: for the ball the distance to the blur streak, for the table the keypoints
predicted and annotated visible; `avg_dist` is the mean distance to the ball centre, or
to the keypoints, over the detections that are not the -100 sentinel.

Per batch: the evaluation transform (a bilinear resize to the model's input, no
augmentation), the detector's forward (bf16 through the port's kernels on the card, f32
on the CPU, as `BallDetector` / `TableDetector` run it), optionally the flip test for the
ball, and the sub-pixel peaks (threshold -inf for the ball, 0.1 for the table).

    python -m upliftingtabletennis_torch.eval.run_detection_eval \\
        --task ball --checkpoints <ckpt1> <ckpt2> ... --data_root <root> [--device cpu]
"""
from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch

__all__ = ["load_detector", "detections", "detection_metrics", "evaluate_checkpoint", "main"]


def load_detector(task: str, ckpt_path: str, resolution=None, device="cuda"):
    """(the detector of a checkpoint on `device`, the checkpoint's metadata). The input is
    `resolution` (W, H) when given, else the one the checkpoint was trained at (its
    metadata's `resolution`, as `run_detection` writes it, or `render_res`, as
    `closed_loop` writes it), else the model's own."""
    from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint

    state, _, info = load_checkpoint(ckpt_path)
    if resolution is None:
        resolution = info.get("resolution", info.get("render_res"))
    cls = BallDetector if task == "ball" else TableDetector
    return cls(info.get("model", "wasb"), state,
               resolution=None if resolution is None else tuple(resolution), device=device), info


def detections(task: str, det, data_root: str, batch_size=8, eval_resolution=None,
               limit=None, flip_test=False, in_frames=3):
    """(preds (N, P, 3), gts (N, P', 3)) at the evaluation resolution (1920x1080 unless
    given) of detector `det` on the TTHQ test split of `data_root`, on the CPU, in whole
    batches of `batch_size` (a last partial batch is left out, as in the JAX protocol).
    The ball's gts rows are (centre, streak min, streak max)."""
    from upliftingtabletennis_torch.data import detection as D
    from upliftingtabletennis_torch.data.image_transforms import augment_detection_batch
    from upliftingtabletennis_torch.ops.heatmap_decode import flip_test_heatmaps
    from upliftingtabletennis_torch.ops.peak import extract_peaks
    from upliftingtabletennis_torch.train.run_detection import eval_coords

    dev = det.device
    MW, MH = det.resolution
    EW, EH = eval_resolution or (D.EVAL_WIDTH, D.EVAL_HEIGHT)
    if task == "ball":
        index = D.load_tthq_ball_index(data_root, "test")
        load = partial(D.load_ball_batch, in_frames=in_frames)
    else:
        index = D.load_tthq_table_index(data_root, "test")
        load = D.load_table_batch
    if limit:
        index = index[:limit]
    threshold = float("-inf") if task == "ball" else 0.1

    preds_all, gts_all = [], []
    with torch.no_grad():
        for s in range(0, len(index) - batch_size + 1, batch_size):
            imgs, coords, vis = load(data_root, index[s:s + batch_size])
            if coords.ndim == 2:
                coords = coords[:, None]
            imgs, coords, vis = (torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.float32)
                                 for a in (imgs, coords, vis))
            x, c_model, v = augment_detection_batch(None, imgs, coords, vis, (MW, MH),
                                                    train=False)
            x = x.to(det.dtype)
            # the horizontal flip test is for the ball only: mirroring swaps the table's
            # left and right keypoints
            heat = flip_test_heatmaps(det._forward, x) if flip_test else det._forward(x)
            preds = extract_peaks(heat.permute(0, 3, 1, 2).float(), EW, EH, threshold)
            gts = torch.cat([eval_coords(c_model, (MW, MH), (EW, EH)), v[..., None]], -1)
            preds_all.append(preds.cpu())
            gts_all.append(gts.cpu())
    return torch.cat(preds_all), torch.cat(gts_all)


def detection_metrics(task: str, preds, gts) -> dict:
    """{"pck2", "pck5", "pck10", "pck20", "avg_dist"} of `detections`' output."""
    from upliftingtabletennis_torch.eval import metrics as M

    out = {}
    for tol in (2, 5, 10, 20):
        if task == "ball":  # gts rows: (centre, streak min, streak max)
            out[f"pck{tol}"] = float(M.pck_ball(preds[:, 0], gts[:, 0, :2], gts[:, 1, :2],
                                                gts[:, 2, :2], tol))
        else:
            out[f"pck{tol}"] = float(M.pck_keypoints(preds, gts, tol))
    out["avg_dist"] = float(M.average_distance(preds, gts[:, :1] if task == "ball" else gts))
    return out


def evaluate_checkpoint(task: str, ckpt_path: str, data_root: str, batch_size=8,
                        resolution=None, eval_resolution=None, limit=None, flip_test=False,
                        device="cuda"):
    """`detection_metrics` of a checkpoint on the TTHQ test split of `data_root`.
    `resolution` (W, H) overrides the model input; `eval_resolution` the metric's
    1920x1080."""
    det, info = load_detector(task, ckpt_path, resolution, device)
    preds, gts = detections(task, det, data_root, batch_size, eval_resolution, limit,
                            flip_test, info.get("in_frames", 3))
    return detection_metrics(task, preds, gts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", choices=["ball", "table"], default="ball")
    p.add_argument("--checkpoints", nargs="+", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--flip_test", action="store_true",
                   help="horizontal flip-test TTA (ball only)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    results = {}
    for ckpt in args.checkpoints:
        m = evaluate_checkpoint(args.task, ckpt, args.data_root, args.batch_size,
                                limit=args.limit, flip_test=args.flip_test, device=args.device)
        print(f"{ckpt}: " + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
        results[ckpt] = m
    return results


if __name__ == "__main__":
    main()
