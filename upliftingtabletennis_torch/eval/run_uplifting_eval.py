"""Uplifting evaluation CLI: the TTST protocol (with the robustness suite) and TT3D.

Port of `upliftingtabletennis_tpu/eval/run_uplifting_eval.py`:

    python -m upliftingtabletennis_torch.eval.run_uplifting_eval \\
        --checkpoint <save_dir>/<run>/model --ttst_dir <root>/ttst [--tt3d_dir <root>] \\
        [--device cpu]

TTST: the mean 2D reprojection error of the predicted 3D positions through the stored
cameras against the annotated detections, in px at 1920x1080 (half-pixel rescaling) and
normalised by that diagonal; the spin's accuracy and macro F1 from the flight-frame
omega_y; under Identity, HalfFPS, Drop(0.1, 0.1) and Combine (`eval/robustness.py`).
TT3D: the mean 3D position error (cm) per view (back, side, oblique) with and without
detection noise. The model runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["EVAL_W", "EVAL_H", "load_uplifting", "eval_ttst", "eval_tt3d", "main"]

EVAL_W, EVAL_H = 1920, 1080


def load_uplifting(checkpoint: str, device="cuda"):
    """(model on `device` in eval mode, transform_mode) from a port checkpoint (a state dict
    with its `.json`), or from a `.pt` checkpoint of the original reference (no `.json`
    beside it), whose weights `utils/port_torch.py` maps."""
    if (os.path.isfile(checkpoint) and checkpoint.endswith(".pt")
            and not os.path.isfile(checkpoint + ".json")):
        from upliftingtabletennis_torch.pipeline.interface import UpliftingModel

        up = UpliftingModel.from_reference_checkpoint(checkpoint, device=device)
        return up.model, up.transform_mode
    from upliftingtabletennis_torch.utils.checkpoint import load_model_from_checkpoint

    model, _, _, info = load_model_from_checkpoint(checkpoint)
    return model.to(resolve_device(device)), info.get("transform_mode", "global")


def _norm_table(table):
    from upliftingtabletennis_torch.core.geometry import HEIGHT, WIDTH

    t = table.copy()
    t[..., 0] /= WIDTH
    t[..., 1] /= HEIGHT
    return t


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


@torch.no_grad()
def eval_ttst(model, transform_mode, ttst, special_transform, batch_size=64):
    """One TTST pass under a robustness transform; returns mean_2d_px, std_2d_px,
    mean_2d_normed, spin_accuracy and spin_macro_f1."""
    from upliftingtabletennis_torch.core.geometry import (HEIGHT, WIDTH, transform_rotation_axes,
                                                          world2img)

    device = next(model.parameters()).device
    per_traj, scores, labels = [], [], []
    N = len(ttst)
    for s in range(0, N, batch_size):
        sl = slice(s, min(s + batch_size, N))
        data = {"r_img": ttst.r_img[sl] / np.array([WIDTH, HEIGHT], np.float32),
                "table_img": _norm_table(ttst.table_img[sl]), "mask": ttst.mask[sl].copy(),
                "times": ttst.times[sl].copy()}
        data = special_transform(data)
        rot, pos = model(*_to(device, data["r_img"], data["table_img"], data["mask"],
                              data["times"]))
        if transform_mode == "global":
            rot = transform_rotation_axes(rot, pos)
        Mext, Mint = _to(device, ttst.Mext[sl], ttst.Mint[sl])
        pred2d = world2img(pos, Mext[:, None], Mint[:, None]).cpu().numpy()
        rot = rot.cpu().numpy()
        # reprojection and annotations at the evaluation resolution (half-pixel rescaling)
        gt2d = data["r_img"] * np.array([WIDTH, HEIGHT])
        sx, sy = EVAL_W / WIDTH, EVAL_H / HEIGHT
        pred2d = (pred2d + 0.5) * np.array([sx, sy]) - 0.5
        gt2d = (gt2d + 0.5) * np.array([sx, sy]) - 0.5
        m = data["mask"]
        d = np.sqrt(np.sum((pred2d - gt2d) ** 2, axis=-1))
        per_traj.append(np.sum(d * m, axis=1) / np.maximum(np.sum(m, axis=1), 1))
        scores.append(rot[:, 1])
        labels.append(ttst.spin_class[sl])

    per_traj = np.concatenate(per_traj)
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    ann = (labels == 1) | (labels == 2)
    y = (labels[ann] == 1).astype(int)
    sc = scores[ann]
    tp = int(((y == 1) & (sc > 0)).sum())
    fn = int(((y == 1) & (sc <= 0)).sum())
    tn = int(((y == 0) & (sc < 0)).sum())
    fp = int(((y == 0) & (sc >= 0)).sum())
    total = max(tp + tn + fp + fn, 1)
    f1p = 2 * tp / max(2 * tp + fp + fn, 1)
    f1m = 2 * tn / max(2 * tn + fn + fp, 1)
    diag = (EVAL_W ** 2 + EVAL_H ** 2) ** 0.5
    return {"mean_2d_px": float(np.mean(per_traj)), "std_2d_px": float(np.std(per_traj)),
            "mean_2d_normed": float(np.mean(per_traj) / diag),
            "spin_accuracy": (tp + tn) / total, "spin_macro_f1": (f1p + f1m) / 2}


@torch.no_grad()
def eval_tt3d(model, transform_mode, base_dir, batch_size=64):
    """{(view, noise): (mean, std) 3D error in cm} per view and for all views together."""
    from upliftingtabletennis_torch.data.tt3d import load_tt3d

    device = next(model.parameters()).device
    results = {}
    for noise in (True, False):
        all_m = []
        for view in ("back", "side", "oblique"):
            try:
                data = load_tt3d(base_dir, view, noise)
            except FileNotFoundError:
                continue
            ms = []
            for s in range(0, len(data), batch_size):
                sl = slice(s, min(s + batch_size, len(data)))
                _, pos = model(*_to(device, data.r_img[sl], data.table_img[sl], data.mask[sl],
                                    data.times[sl]))
                pos = pos.cpu().numpy()
                m = data.mask[sl]
                d = np.sqrt(np.sum((pos - data.r_world[sl]) ** 2, axis=-1))
                ms.append(np.sum(d * m, axis=1) / np.maximum(np.sum(m, axis=1), 1))
            if ms:
                m = np.concatenate(ms)
                results[(view, noise)] = (float(np.mean(m) * 100), float(np.std(m) * 100))
                all_m.append(m)
        if all_m:
            m = np.concatenate(all_m)
            results[("all", noise)] = (float(np.mean(m) * 100), float(np.std(m) * 100))
    return results


def main(argv=None):
    """Print the TTST and TT3D results; returns {"ttst": {transform: metrics}, "tt3d":
    {(view, noise): (mean, std)}}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--ttst_dir", default=None)
    p.add_argument("--tt3d_dir", default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from upliftingtabletennis_torch.data.ttst import load_ttst
    from upliftingtabletennis_torch.eval.robustness import STANDARD_SUITE

    model, transform_mode = load_uplifting(args.checkpoint, args.device)
    out = {"ttst": {}, "tt3d": {}}
    if args.ttst_dir:
        ttst = load_ttst(args.ttst_dir, "test")
        for name, make in STANDARD_SUITE:
            m = eval_ttst(model, transform_mode, ttst, make())
            out["ttst"][name] = m
            print(f"[TTST/{name}] 2D err {m['mean_2d_px']:.2f}px "
                  f"(normed {m['mean_2d_normed']:.4f})  spin acc {m['spin_accuracy']:.4f} "
                  f"macro-F1 {m['spin_macro_f1']:.4f}")
    if args.tt3d_dir:
        out["tt3d"] = eval_tt3d(model, transform_mode, args.tt3d_dir)
        for (view, noise), (mean, std) in sorted(out["tt3d"].items(), key=str):
            print(f"[TT3D/{view} noise={noise}] 3D err {mean:.2f} +- {std:.2f} cm")
    return out


if __name__ == "__main__":
    main()
