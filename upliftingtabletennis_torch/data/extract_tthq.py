"""TTHQ raw-annotation extraction.

Port of `upliftingtabletennis_tpu/data/extract_tthq.py`: the per-video event and keypoint
annotations become the trajectory segments and the ball and table tables that the
detection and rally datasets read, with a camera per annotated frame regressed from the
table keypoints:

* events -> trajectory segments (Begin / Hit / Bounce / End / Netz / Frontspin /
  Backspin; two consecutive hits keep the later, a double bounce its midpoint);
* a camera per annotated frame (`regress_cameras`): the port's RANSAC calibration on
  `device` (the card unless the caller asks for the CPU), its draws from a generator
  seeded with the frame number (JAX seeds `PRNGKey(frame)`) or given, kept with at
  least 6 inliers;
* `write_tables`: trajectories.csv, ball_detection.csv, table_detection.csv and
  camera_matrices.csv (sep ';') in the readers' formats.

The functions take the annotations as a mapping of columns (`data/extract_ttst.
read_csv_columns`'s dict, or a DataFrame).
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["INLIER_THRESHOLD", "load_trajectories", "load_ball_keypoints",
           "load_table_keypoints", "regress_cameras", "write_tables"]

INLIER_THRESHOLD = 6  # the fewest inliers of a camera that is kept


def load_trajectories(events, video_name: str, fps: float) -> List[tuple]:
    """The event stream (columns 'frame', 'event') -> [(video, start, end, bounce,
    spin_class, status, usable, fps), ...]."""
    out = []
    start, end, bounce = None, None, None
    spin_class, status, usable = 0, "intermediate", True
    for frame, event in zip(np.asarray(events["frame"]), np.asarray(events["event"])):
        if event == "Begin":
            start = frame
            status = "first"
        elif event == "Hit" and start is None:
            start = frame
        elif event == "Hit" and start == frame - 1:
            start = frame  # two consecutive hits: the later one
        elif event == "End":
            end = frame
            status = "last"
            out.append((video_name, start, end, bounce, spin_class, status, usable, fps))
            start, end, bounce = None, None, None
            spin_class, usable, status = 0, True, "intermediate"
        elif event == "Hit" and start is not None:
            end = frame
            out.append((video_name, start, end, bounce, spin_class, status, usable, fps))
            start, end, bounce = frame, None, None
            spin_class, usable, status = 0, True, "intermediate"
        elif event == "Bounce":
            if bounce is None:
                bounce = frame
            elif bounce == frame - 1:
                bounce = 0.5 * (bounce + frame)  # a double bounce: the midpoint
        elif event == "Netz":
            usable = False
        elif event == "Frontspin":
            spin_class = 1
        elif event == "Backspin":
            spin_class = 2
    return out


def load_ball_keypoints(keypoints, video_name: str) -> Dict[int, tuple]:
    """frame -> (x, y, flag) of the ball, flags other than 0 only."""
    frames = np.asarray(keypoints["frame"])
    xs, ys = np.asarray(keypoints["ball center_x"]), np.asarray(keypoints["ball center_y"])
    flags = np.asarray(keypoints["ball center_flag"])
    return {frames[i]: (xs[i], ys[i], flags[i]) for i in range(len(frames)) if flags[i] != 0}


def load_table_keypoints(keypoints) -> Dict[int, list]:
    """frame -> [(x, y, flag) x 13] of the frames whose 13 points are all annotated."""
    frames = np.asarray(keypoints["frame"])
    cols = [[np.asarray(keypoints[f"{k:02d}_{c}"]) for c in ("x", "y", "flag")]
            for k in range(1, 14)]
    out = {}
    for i, frame in enumerate(frames):
        pts = [(x[i], y[i], flag[i]) for x, y, flag in cols]
        if all(p[2] != 0 for p in pts):
            out[frame] = pts
    return out


def regress_cameras(table_detections: Mapping[int, list], resolution, device="cuda",
                    dtype=torch.float32, draws: Optional[Mapping[int, tuple]] = None
                    ) -> Dict[int, tuple]:
    """frame -> (Mint, Mext, n_inliers) of each frame with at least 6 visible (flag 2)
    keypoints whose RANSAC calibration keeps at least INLIER_THRESHOLD inliers. draws:
    frame -> (ransac_u, polish_normal), else drawn from a generator seeded with the
    frame."""
    from upliftingtabletennis_torch._device import resolve_device
    from upliftingtabletennis_torch.core.calibration import calibrate_camera

    dev = resolve_device(device)
    out = {}
    for frame, pts in table_detections.items():
        arr = np.asarray(pts, np.float64)
        vis = (arr[:, 2] == 2).astype(np.float32)
        if vis.sum() < 6:
            continue
        u, j = draws[frame] if draws is not None else (None, None)
        Mint, Mext, n_in = calibrate_camera(
            torch.as_tensor(arr[:, :2].astype(np.float32), dtype=dtype, device=dev),
            torch.as_tensor(vis, dtype=dtype, device=dev), tuple(resolution), True,
            ransac_u=u, polish_normal=j, generator=torch.Generator().manual_seed(int(frame)))
        if int(n_in) >= INLIER_THRESHOLD:
            out[frame] = (Mint.cpu().numpy(), Mext.cpu().numpy(), int(n_in))
    return out


def write_tables(out_dir: str, trajectories, ball_detections, table_detections, cameras=None):
    """Write trajectories.csv, ball_detection.csv, table_detection.csv and, given cameras,
    camera_matrices.csv (sep ';') in the readers' formats."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "trajectories.csv"), "w") as f:
        f.write("video;start;end;bounce;spin_class;status;usable;fps\n")
        for row in trajectories:
            f.write(";".join(str(x) for x in row) + "\n")
    with open(os.path.join(out_dir, "ball_detection.csv"), "w") as f:
        f.write("video;frame;ball_x;ball_y;ball_flag\n")
        for video, frames in ball_detections.items():
            for frame, (x, y, flag) in sorted(frames.items()):
                f.write(f"{video};{frame};{x};{y};{flag}\n")
    with open(os.path.join(out_dir, "table_detection.csv"), "w") as f:
        f.write("video;frame;" + ";".join(f"point_{k}_x;point_{k}_y;point_{k}_flag"
                                          for k in range(1, 14)) + "\n")
        for video, frames in table_detections.items():
            for frame, pts in sorted(frames.items()):
                cells = ";".join(f"{x};{y};{flag}" for x, y, flag in pts)
                f.write(f"{video};{frame};{cells}\n")
    if cameras:
        with open(os.path.join(out_dir, "camera_matrices.csv"), "w") as f:
            f.write("video;frame;num_inliers;Mint;Mext\n")
            for video, frames in cameras.items():
                for frame, (Mint, Mext, n_in) in sorted(frames.items()):
                    f.write(f"{video};{frame};{n_in};"
                            f"{','.join(map(str, np.asarray(Mint).ravel()))};"
                            f"{','.join(map(str, np.asarray(Mext).ravel()))}\n")
