"""TTST dataset extraction from the raw annotation CSVs, CLI.

Port of `upliftingtabletennis_tpu/data/extract_ttst.py`: the per-video
`<vid>_events.csv` / `<vid>_keypoints.csv` pairs become the per-trajectory layout that
`data/ttst.py` reads (`trajectory_%04d/{r_img, times, Mint, Mext, hits,
spin_class}.npy`, and `frames/*.png` extracted from `<vid>.mp4` where it exists):

    python -m upliftingtabletennis_torch.data.extract_ttst --data_path <raw> \\
        --save_path <root>/ttst [--videos 01 02 ...] [--no_frames] [--device cpu]

* events: a trajectory is (Begin, Bounce, End) with a Frontspin (class 1) or Backspin
  (class 2) annotation between Begin and End; one without is dropped;
* timestamps skip unannotated ball frames but keep the wall time (50 fps); the bounce's
  time is taken from the event's start;
* the camera: cameras are static per sequence, so each table keypoint's observations over
  the event's frames are reduced to their median, and the 13 points go through the
  port's RANSAC calibration (`core/calibration.calibrate_camera`) on `device` (the card
  unless the caller asks for the CPU), its draws from a generator seeded with the
  event's index (JAX seeds `PRNGKey(index)`) or given (`draws`, to hold it against JAX's).

CSV conventions: sep ';', the header on the second line; keypoint columns '01_x', '01_y',
'01_flag' ... '13_*'; flag 2 means annotated. The CSVs are read by `read_csv_columns`
(standard library, numbers as pandas reads them), not pandas. Frames are cut with OpenCV,
imported inside `extract_images` as in JAX.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FPS", "NUM_TABLE_POINTS", "DEFAULT_RESOLUTION", "read_csv_columns", "parse_events",
           "parse_ball_keypoints", "parse_table_keypoints", "event_keypoints",
           "regress_event_camera", "transform_annotations", "extract_images",
           "generate_inference_dataset", "main"]

FPS = 50
NUM_TABLE_POINTS = 13
DEFAULT_RESOLUTION = (2560, 1440)  # the TTST videos' resolution


def _column(cells: List[str]) -> np.ndarray:
    """A CSV column as pandas types it: int64 when every cell is an integer, float64 when
    every cell is a number or empty (NaN), else the strings."""
    for kind in (int, float):
        try:
            if kind is int:
                return np.array([int(c) for c in cells], np.int64)
            return np.array([float(c) if c.strip() else np.nan for c in cells], np.float64)
        except ValueError:
            continue
    return np.array(cells, dtype=object)


def read_csv_columns(path: str, sep: str = ";", header: int = 0) -> Dict[str, np.ndarray]:
    """A CSV file as {column name: array}, the header on line `header` (0-based; the lines
    above it skipped), blank lines skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep)][header:]
    names, body = rows[0], [r for r in rows[1:] if any(c.strip() for c in r)]
    return {name: _column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(names)}


def parse_events(events) -> Tuple[List[Tuple[int, int, int]], List[int]]:
    """(begin, bounce, end) of each trajectory and its spin class, from the columns
    'frame' and 'event' of a mapping (a `read_csv_columns` dict or a DataFrame)."""
    events_out, spins = [], []
    spin_class = 0
    begin = bounce = end = None
    for frame, event in zip(np.asarray(events["frame"]), np.asarray(events["event"])):
        if event == "Frontspin" and begin is not None:
            spin_class = 1
        elif event == "Backspin" and begin is not None:
            spin_class = 2

        if event == "Begin" and bounce is None and end is None:
            begin = frame
        elif event == "Bounce" and begin is not None and end is None:
            bounce = frame
        elif event == "End" and begin is not None and bounce is not None:
            end = frame
            if spin_class != 0:
                events_out.append((int(begin), int(bounce), int(end)))
                spins.append(spin_class)
            spin_class = 0
            begin = bounce = end = None
    return events_out, spins


def parse_ball_keypoints(keypoints) -> Dict[int, Tuple[float, float]]:
    """frame -> (x, y) of the annotated (flag 2) ball keypoints."""
    out = {}
    for frame, x, y, flag in zip(*(np.asarray(keypoints[k])
                                   for k in ("frame", "ball_x", "ball_y", "ball_flag"))):
        if int(flag) == 2:
            out[int(frame)] = (float(x), float(y))
    return out


def parse_table_keypoints(keypoints, begin: int, end: int) -> Dict[int, list]:
    """{point index (1-based): [(x, y), ...]} of the annotated table keypoints over the
    frames [begin, end]."""
    out: Dict[int, list] = {}
    frames = np.asarray(keypoints["frame"])
    cols = {(p, c): np.asarray(keypoints[f"{p:02}_{c}"])
            for p in range(1, NUM_TABLE_POINTS + 1) for c in ("x", "y", "flag")}
    for i in np.nonzero((frames >= begin) & (frames <= end))[0]:
        for p in range(1, NUM_TABLE_POINTS + 1):
            if int(cols[p, "flag"][i]) == 2:
                out.setdefault(p, []).append((float(cols[p, "x"][i]), float(cols[p, "y"][i])))
    return out


def event_keypoints(table_annotations: Mapping[int, list]) -> Tuple[np.ndarray, np.ndarray]:
    """(points (13, 2) float32, visibility (13,) float32): each observed point's median
    observation, -1 and 0 for the others."""
    pts = np.full((NUM_TABLE_POINTS, 2), -1.0, np.float32)
    vis = np.zeros((NUM_TABLE_POINTS,), np.float32)
    for p, obs in table_annotations.items():
        pts[p - 1] = np.median(np.asarray(obs, np.float64), axis=0)
        vis[p - 1] = 1.0
    return pts, vis


def regress_event_camera(table_annotations: Mapping[int, list], resolution, seed: int = 0,
                         device="cuda", dtype=torch.float32, draws=None):
    """(Mint, Mext, n_inliers) of an event from its table observations (`event_keypoints`
    then RANSAC calibration on `device` in `dtype`). draws: (ransac_u, polish_normal), else
    drawn from a generator seeded with `seed`. Raises with fewer than 6 observed points."""
    from upliftingtabletennis_torch._device import resolve_device
    from upliftingtabletennis_torch.core.calibration import calibrate_camera

    pts, vis = event_keypoints(table_annotations)
    if vis.sum() < 6:
        raise ValueError(f"only {int(vis.sum())} visible table keypoints, need >= 6")
    dev = resolve_device(device)
    u, j = draws if draws is not None else (None, None)
    Mint, Mext, n = calibrate_camera(torch.as_tensor(pts, dtype=dtype, device=dev),
                                     torch.as_tensor(vis, dtype=dtype, device=dev),
                                     tuple(resolution), True, ransac_u=u, polish_normal=j,
                                     generator=torch.Generator().manual_seed(seed))
    return Mint.cpu().numpy(), Mext.cpu().numpy(), int(n)


def transform_annotations(data_path: str, paths=("01", "02", "03", "04", "05", "06"),
                          resolution=DEFAULT_RESOLUTION, device="cuda", dtype=torch.float32,
                          draws: Optional[Sequence] = None):
    """The raw CSVs of the videos `paths` -> per event (r_imgs, timestamps, Mints, Mexts,
    bounces, spin_classes, vids_and_frames). draws: per event, the calibration's draws
    (`regress_event_camera`)."""
    events_all, spins_all = [], []
    ball_lists, table_lists, video_list = [], [], []
    for path in paths:
        kp_csv = os.path.join(data_path, f"{path}_keypoints.csv")
        ev_csv = os.path.join(data_path, f"{path}_events.csv")
        if not (os.path.exists(kp_csv) and os.path.exists(ev_csv)):
            continue
        keypoints = read_csv_columns(kp_csv, ";", header=1)
        events, spins = parse_events(read_csv_columns(ev_csv, ";", header=1))
        ball_by_frame = parse_ball_keypoints(keypoints)
        for begin, bounce, end in events:
            table_lists.append(parse_table_keypoints(keypoints, begin, end))
            ball_lists.append({f: ball_by_frame[f] for f in range(begin, end + 1)
                               if f in ball_by_frame})
            video_list.append(path)
        events_all += events
        spins_all += spins

    bounces = [np.array([(b - s) / FPS]) for (s, b, _) in events_all]
    timestamps, r_imgs, vids_and_frames = [], [], []
    for event_balls, video in zip(ball_lists, video_list):
        ts, xy, fr = [], [], []
        t = 0.0
        for frame in range(min(event_balls), max(event_balls) + 1):
            if frame in event_balls:
                ts.append(t)
                xy.append(event_balls[frame])
                fr.append(frame)
            t += 1.0 / FPS
        timestamps.append(np.asarray(ts))
        r_imgs.append(np.asarray(xy))
        vids_and_frames.append((video, fr))

    Mints, Mexts = [], []
    for i, table_annotations in enumerate(table_lists):
        Mint, Mext, _ = regress_event_camera(table_annotations, resolution, seed=i,
                                             device=device, dtype=dtype,
                                             draws=None if draws is None else draws[i])
        Mints.append(Mint)
        Mexts.append(Mext)
    return r_imgs, timestamps, Mints, Mexts, bounces, spins_all, vids_and_frames


def extract_images(video_path: str, frames: List[int], out_dir: str) -> bool:
    """Frames [min - 1, max + 1] of a video as `out_dir/frames/NNN.png`; False when the
    video does not open."""
    import cv2

    os.makedirs(os.path.join(out_dir, "frames"), exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return False
    lo, hi = min(frames), max(frames)
    for idx, frame in enumerate(range(lo - 1, hi + 2)):
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame)
        ret, img = cap.read()
        if not ret:
            continue
        cv2.imwrite(os.path.join(out_dir, "frames", f"{idx:03}.png"), img)
    return True


def generate_inference_dataset(data_path: str, save_path: str,
                               paths=("01", "02", "03", "04", "05", "06"),
                               resolution=DEFAULT_RESOLUTION, extract_frames: bool = True,
                               device="cuda") -> int:
    """Write the trajectory_%04d layout `data/ttst.py` reads; returns the count."""
    os.makedirs(save_path, exist_ok=True)
    r_imgs, timestamps, Mints, Mexts, bounces, spin_classes, vnf = transform_annotations(
        data_path, paths, resolution, device)
    for i in range(len(r_imgs)):
        out = os.path.join(save_path, f"trajectory_{i:04}")
        os.makedirs(out, exist_ok=True)
        for name, value in (("r_img", r_imgs[i]), ("times", timestamps[i]), ("Mint", Mints[i]),
                            ("Mext", Mexts[i]), ("hits", bounces[i]),
                            ("spin_class", spin_classes[i])):
            np.save(os.path.join(out, f"{name}.npy"), value)
        if extract_frames:
            video_path = os.path.join(data_path, f"{vnf[i][0]}.mp4")
            if os.path.exists(video_path):
                extract_images(video_path, vnf[i][1], out)
    return len(r_imgs)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_path", required=True, help="dir with <vid>_{events,keypoints}.csv")
    p.add_argument("--save_path", required=True)
    p.add_argument("--videos", nargs="*", default=["01", "02", "03", "04", "05", "06"])
    p.add_argument("--resolution", type=int, nargs=2, default=list(DEFAULT_RESOLUTION))
    p.add_argument("--no_frames", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    n = generate_inference_dataset(args.data_path, args.save_path, tuple(args.videos),
                                   tuple(args.resolution), extract_frames=not args.no_frames,
                                   device=args.device)
    print(f"wrote {n} trajectories to {args.save_path}")
    return n


if __name__ == "__main__":
    main()
