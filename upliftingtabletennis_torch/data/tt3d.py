"""TT3D (Gossard et al.) external evaluation dataset reader, numpy.

Port of `upliftingtabletennis_tpu/data/tt3d.py` (its own copy). Layout: per view,
`<base>/tt3d/data/evaluation/{back,side,oblique}[_no_noise]/*.csv` with the columns u, v,
X, Y, Z, Timestamp, and one `<view>.yaml` camera file with rvec, tvec, f, h and w.

* The rotation is Rodrigues' of rvec; the extrinsic matrix is right-multiplied by the
  change of coordinate system [[0,-1,0,0],[1,0,0,0],[0,0,1,-TABLE_HEIGHT],[0,0,0,1]],
  world points mapped with its inverse.
* Image coordinates are normalised by the camera's (w, h), not the working resolution.
* The frame rate from the mean time step; the first bounce by the reference's run-length
  hit detector; padding to 50 with a mask.

The CSVs are read with numpy (the JAX reader uses pandas, which the card's installs do
not name); the camera file needs PyYAML, imported when a file is read.
"""
from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np

from upliftingtabletennis_torch.core.geometry import (TABLE_HEIGHT, TABLE_LENGTH, TABLE_POINTS,
                                                      TABLE_WIDTH)

__all__ = ["SEQUENCE_LEN", "TRANS", "TT3DBatch", "rodrigues", "read_csv", "load_tt3d"]

SEQUENCE_LEN = 50


class TT3DBatch(NamedTuple):
    r_img: np.ndarray       # (N, 50, 2) normalised by (w, h)
    table_img: np.ndarray   # (N, 13, 3) normalised + visibility
    mask: np.ndarray        # (N, 50)
    r_world: np.ndarray     # (N, 50, 3)
    times: np.ndarray       # (N, 50)
    hits: np.ndarray        # (N, 1) first bounce time or -1
    Mint: np.ndarray        # (N, 3, 3)
    Mext: np.ndarray        # (N, 4, 4)
    framerate: np.ndarray   # (N,)

    def __len__(self):
        return self.r_img.shape[0]


def rodrigues(rvec):
    """Rotation matrix of a rotation vector."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


TRANS = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, -TABLE_HEIGHT], [0, 0, 0, 1]],
                 np.float64)


def _count_first_hit(r_world, direction, fps):
    """The first table-bounce time by the reference's run-length logic, or -1."""
    x, y, z = r_world[:, 0], r_world[:, 1], r_world[:, 2]
    if direction == "left_to_right":
        opp = (-0.01 > x) & (x > -TABLE_LENGTH / 2)
        own = (TABLE_LENGTH / 2 > x) & (x > 0.01)
    else:
        opp = (TABLE_LENGTH / 2 > x) & (x > 0.01)
        own = (-0.01 > x) & (x > -TABLE_LENGTH / 2)
    low = z < TABLE_HEIGHT + 0.04
    ony = np.abs(y) < TABLE_WIDTH / 2
    hits = []
    for m in (low & ony & opp, low & ony & own):
        start = None
        for i, b in enumerate(m):
            if b and (i == 0 or not m[i - 1]):
                start = i
            if not b and i != 0 and m[i - 1]:
                end = i - 1
                hits.append(0.75 * (end + start) / 2 / fps
                            + 0.25 * (np.argmin(z[start:end + 1]) + start) / fps)
    return min(hits) if hits else -1.0


def read_csv(path: str) -> dict:
    """Column name -> float64 values of a CSV with a header line."""
    with open(path) as f:
        names = [n.strip() for n in f.readline().split(",")]
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2, dtype=np.float64)
    return {n: data[:, i] for i, n in enumerate(names)}


def load_tt3d(base_dir: str, view: str = "back", noise: bool = True) -> TT3DBatch:
    assert view in ("back", "side", "oblique")
    import yaml

    folder = view if noise else f"{view}_no_noise"
    data_dir = os.path.join(base_dir, "tt3d", "data", "evaluation", folder)
    files = sorted(glob.glob(os.path.join(data_dir, "*.csv")))
    if not files:
        raise FileNotFoundError(f"no CSVs in {data_dir}")
    with open(os.path.join(base_dir, "tt3d", "data", "evaluation", f"{view}.yaml")) as f:
        cam = yaml.safe_load(f)
    rvec = np.asarray(cam["rvec"], np.float64).ravel()
    tvec = np.asarray(cam["tvec"], np.float64).ravel()
    fcl, h, w = float(cam["f"]), float(cam["h"]), float(cam["w"])

    Mint = np.array([[fcl, 0, w / 2], [0, fcl, h / 2], [0, 0, 1]])
    Mext = np.eye(4)
    Mext[:3, :3] = rodrigues(rvec)
    Mext[:3, 3] = tvec
    Mext = Mext @ TRANS

    # the table points through the composed camera
    tp = np.concatenate([TABLE_POINTS, np.ones((13, 1))], -1)
    cam_pts = (Mext @ tp.T).T
    img_pts = (Mint @ (cam_pts[:, :3] / cam_pts[:, 3:4]).T).T
    table_img = img_pts[:, :2] / img_pts[:, 2:3]
    table_img = np.concatenate([table_img / np.array([w, h]), np.ones((13, 1))],
                               -1).astype(np.float32)

    N = len(files)
    out = TT3DBatch(
        np.zeros((N, SEQUENCE_LEN, 2), np.float32),
        np.broadcast_to(table_img, (N, 13, 3)).copy(),
        np.zeros((N, SEQUENCE_LEN), np.float32),
        np.zeros((N, SEQUENCE_LEN, 3), np.float32),
        np.zeros((N, SEQUENCE_LEN), np.float32),
        np.full((N, 1), -1.0, np.float32),
        np.broadcast_to(Mint.astype(np.float32), (N, 3, 3)).copy(),
        np.broadcast_to(Mext.astype(np.float32), (N, 4, 4)).copy(),
        np.zeros((N,), np.float32),
    )
    inv_trans = np.linalg.inv(TRANS)
    for i, path in enumerate(files):
        cols = read_csv(path)
        r_img = np.stack([cols["u"], cols["v"]], -1)
        r_world = np.stack([cols["X"], cols["Y"], cols["Z"]], -1)
        times = cols["Timestamp"]
        T = min(len(r_img), SEQUENCE_LEN)
        # world coordinates into this package's system
        rw = np.concatenate([r_world, np.ones((len(r_world), 1))], -1)
        rw = (inv_trans @ rw.T).T[:, :3]
        out.r_img[i, :T] = r_img[:T] / np.array([w, h])
        out.r_world[i, :T] = rw[:T]
        out.times[i, :T] = times[:T]
        out.mask[i, :T] = 1.0
        dt = np.diff(times[:T])
        fps = 1.0 / np.mean(dt) if len(dt) and np.mean(dt) > 0 else 0.0
        out.framerate[i] = fps
        direction = "left_to_right" if rw[0, 0] < 0 else "right_to_left"
        out.hits[i, 0] = _count_first_hit(rw[:T], direction, fps)
    return out
