"""TTST real-video evaluation dataset reader, numpy.

Port of `upliftingtabletennis_tpu/data/ttst.py` (its own copy). Layout per trajectory
directory:
  r_img.npy (T, 2) 2D ball detections at the 2560x1440 working resolution,
  times.npy (T,), hits.npy (K,), Mint.npy (3, 3), Mext.npy (4, 4),
  spin_class.npy () in {0: not annotated, 1: topspin, 2: backspin}.

val = the first 33% of the sorted trajectory directories, test = the rest. Sequences are
padded or cropped to 50 with a mask; coordinates are normalised by (WIDTH, HEIGHT)
downstream (`data/augment.eval_augment`). The table keypoints are the 13 table points
projected through the stored camera, all visible.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from upliftingtabletennis_torch.core.geometry import TABLE_POINTS

__all__ = ["BACKSPIN_CLASS", "TOPSPIN_CLASS", "NOT_ANNOTATED_CLASS", "SEQUENCE_LEN",
           "TTSTBatch", "project_points", "load_ttst"]

BACKSPIN_CLASS = 2
TOPSPIN_CLASS = 1
NOT_ANNOTATED_CLASS = 0

SEQUENCE_LEN = 50


class TTSTBatch(NamedTuple):
    r_img: np.ndarray       # (N, 50, 2) px
    table_img: np.ndarray   # (N, 13, 3) px + visibility
    mask: np.ndarray        # (N, 50)
    times: np.ndarray       # (N, 50)
    hits: np.ndarray        # (N, 1)
    Mint: np.ndarray        # (N, 3, 3)
    Mext: np.ndarray        # (N, 4, 4)
    spin_class: np.ndarray  # (N,)

    def __len__(self):
        return self.r_img.shape[0]


def project_points(points: np.ndarray, Mext: np.ndarray, Mint: np.ndarray) -> np.ndarray:
    """World points (N, 3) -> pixels (N, 2) through one camera, in float32."""
    p = np.concatenate([points, np.ones((len(points), 1))], -1).astype(np.float32)
    cam = p @ np.asarray(Mext, np.float32).T
    cam = cam[:, :3] / cam[:, 3:4]
    img = cam @ np.asarray(Mint, np.float32)[:3, :3].T
    return img[:, :2] / img[:, 2:3]


def load_ttst(path: str, mode: str = "val") -> TTSTBatch:
    """Load and pad the TTST layout. mode in {'val', 'test', 'all'}."""
    dirs = sorted(d for d in os.listdir(path) if d.startswith("trajectory_"))
    if mode == "val":
        dirs = dirs[: int(0.33 * len(dirs))]
    elif mode == "test":
        dirs = dirs[int(0.33 * len(dirs)):]
    elif mode != "all":
        raise ValueError(mode)

    N = len(dirs)
    out = TTSTBatch(
        np.zeros((N, SEQUENCE_LEN, 2), np.float32),
        np.zeros((N, 13, 3), np.float32),
        np.zeros((N, SEQUENCE_LEN), np.float32),
        np.zeros((N, SEQUENCE_LEN), np.float32),
        np.full((N, 1), -1.0, np.float32),
        np.zeros((N, 3, 3), np.float32),
        np.zeros((N, 4, 4), np.float32),
        np.zeros((N,), np.float32),
    )
    for i, d in enumerate(dirs):
        p = os.path.join(path, d)
        r_img = np.load(os.path.join(p, "r_img.npy"))
        times = np.load(os.path.join(p, "times.npy"))
        hits = np.load(os.path.join(p, "hits.npy"))
        Mint = np.load(os.path.join(p, "Mint.npy"))
        Mext = np.load(os.path.join(p, "Mext.npy"))
        spin = np.load(os.path.join(p, "spin_class.npy"))
        T = min(len(r_img), SEQUENCE_LEN)
        out.r_img[i, :T] = r_img[:T]
        out.times[i, :T] = times[:T]
        out.mask[i, :T] = 1.0
        if len(hits):
            out.hits[i, 0] = hits[0]
        out.Mint[i] = Mint[:3, :3]
        out.Mext[i] = Mext
        out.spin_class[i] = float(spin)
        table = project_points(TABLE_POINTS, Mext, Mint)
        out.table_img[i] = np.concatenate([table, np.ones((13, 1))], -1)
    return out
