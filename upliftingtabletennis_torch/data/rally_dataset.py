"""TTHQ rally (trajectory) dataset for evaluating the whole pipeline.

Port of `upliftingtabletennis_tpu/data/rally_dataset.py`. The test rallies come from the
TTHQ val/test videos (1, 3, 10), selected by

  usable AND status != 'last' AND no annotated ball or table frame inside
  AND every triplet's frames on disk,

each with its frame triples, fps and annotated spin class. Frames load lazily
(`load_rally_frames`, through `data/detection.load_frame`). `dataset_statistics` counts
frames and trajectories across the dataset layouts. The CSVs (sep ';') are read with the
standard library, not pandas.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

from upliftingtabletennis_torch.data.detection import _rows, load_frame

__all__ = ["VAL_TEST_VIDS", "Rally", "load_tthq_rallies", "load_rally_frames",
           "dataset_statistics"]

VAL_TEST_VIDS = (1, 3, 10)


class Rally(NamedTuple):
    video: int
    fps: float
    spin_class: int
    frames: List[Tuple[int, int, int]]  # (frame, prev, next)


def _frame_exists(data_path, video, frame):
    return os.path.exists(os.path.join(data_path, f"{video:02d}", f"{video:02d}_{frame:06d}.png"))


def _truthy(value: str) -> bool:
    """A CSV cell read as pandas reads a bool or number column: True, or a number equal
    to 1."""
    value = value.strip()
    if value in ("True", "TRUE", "true"):
        return True
    try:
        return float(value) == 1.0
    except ValueError:
        return False


def load_tthq_rallies(root: str) -> List[Rally]:
    """The test rallies of `<root>/tthq` (trajectories.csv with start/end or
    start_frame/end_frame columns)."""
    data_path = os.path.join(root, "tthq")
    ball = _rows(os.path.join(data_path, "ball_detection.csv"))
    table = _rows(os.path.join(data_path, "table_detection.csv"))
    traj = _rows(os.path.join(data_path, "trajectories.csv"))
    s_col = "start_frame" if traj and "start_frame" in traj[0] else "start"
    e_col = "end_frame" if traj and "end_frame" in traj[0] else "end"

    annotated = {v: set() for v in VAL_TEST_VIDS}
    for row in ball + table:
        v = int(float(row["video"]))
        if v in annotated:
            annotated[v].add(int(float(row["frame"])))

    rallies = []
    for row in traj:
        v = int(float(row["video"]))
        if v not in VAL_TEST_VIDS:
            continue
        if not _truthy(row["usable"]) or row["status"].strip() == "last":
            continue
        s, e = int(float(row[s_col])), int(float(row[e_col]))
        if any(f in annotated[v] for f in range(s, e + 1)):
            continue  # rallies overlapping annotated frames are left out
        triples = []
        for f in range(s + 1, e):
            if not all(_frame_exists(data_path, v, g) for g in (f, f - 1, f + 1)):
                break
            triples.append((f, f - 1, f + 1))
        else:
            if triples:
                rallies.append(Rally(v, float(row["fps"]), int(float(row["spin_class"])),
                                     triples))
    return rallies


def load_rally_frames(root: str, rally: Rally):
    """The RGB frames of a rally, float32 (H, W, 3) each, in frame order over [start, end]
    (the first triple's previous frame to the last one's next)."""
    first, last = rally.frames[0][1], rally.frames[-1][2]
    return [load_frame(root, rally.video, f) for f in range(first, last + 1)]


def dataset_statistics(root: str) -> dict:
    """Frame and trajectory counts of the dataset layouts under root (tthq/, ttst/,
    syntheticdata/)."""
    out = {}
    tthq = os.path.join(root, "tthq")
    if os.path.isdir(tthq):
        for csv, key in (("ball_detection.csv", "tthq_ball_frames"),
                         ("table_detection.csv", "tthq_table_frames"),
                         ("trajectories.csv", "tthq_trajectories")):
            path = os.path.join(tthq, csv)
            if os.path.exists(path):
                out[key] = len(_rows(path))
        try:
            out["tthq_test_rallies"] = len(load_tthq_rallies(root))
        except (OSError, KeyError, ValueError):
            pass
    ttst = os.path.join(root, "ttst")
    if os.path.isdir(ttst):
        out["ttst_trajectories"] = len([d for d in os.listdir(ttst)
                                        if d.startswith("trajectory_")])
    synth = os.path.join(root, "syntheticdata")
    if os.path.isdir(synth):
        n = 0
        for mode in os.listdir(synth):
            for direction in os.listdir(os.path.join(synth, mode)):
                n += len([d for d in os.listdir(os.path.join(synth, mode, direction))
                          if d.startswith("trajectory_")])
        out["synthetic_trajectories"] = n
    return out
