"""TTHQ detection dataset: sample indices, frame batches and a threaded prefetcher.

Port of the TTHQ part of `upliftingtabletennis_tpu/data/detection.py` (`:36-164`,
`:372`). Host-side readers produce raw frames and annotations; augmentation, targets
and the loss run on the device (`data/image_transforms.py`, `eval/metrics.py`).

Layout:
* ball: `<root>/tthq/ball_detection.csv` (sep ';', columns video, frame, ball_x, ball_y,
  ball_flag; flag 2 = visible) and frames `<root>/tthq/<video:02d>/<video:02d>_<frame:06d>.png`;
* table: `table_detection.csv` with 13 keypoints per frame (point_<k>_x/_y/_flag).
Videos 1, 3 and 10 are the val + test pool, shuffled with numpy's RandomState(0) and
split in halves. Frames are decoded by `data/png.py` (no cv2). BlurBall waits for the
readers slice (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import csv
import os
import queue
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from upliftingtabletennis_torch.data.png import read_png

__all__ = ["BALL_VISIBLE", "BALL_INVISIBLE", "EVAL_WIDTH", "EVAL_HEIGHT", "BallSample",
           "TableSample", "load_tthq_ball_index", "load_tthq_table_index", "load_frame",
           "load_ball_batch", "load_table_batch", "Prefetcher"]

BALL_VISIBLE = 1
BALL_INVISIBLE = 0
EVAL_WIDTH, EVAL_HEIGHT = 1920, 1080  # metric resolution
VAL_TEST_VIDEOS = (1, 3, 10)


class BallSample(NamedTuple):
    video: int
    frames: Tuple[int, int, int]  # (current, prev, next)
    coords: Tuple[float, float]
    visibility: int
    # blur streak endpoints (equal to coords for TTHQ)
    min_coords: Tuple[float, float]
    max_coords: Tuple[float, float]


class TableSample(NamedTuple):
    video: int
    frame: int
    keypoints: np.ndarray  # (13, 3) x, y, visibility


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=";"))


def _number(row, key, default):
    value = row.get(key)
    return default if value is None or value.strip() == "" else float(value)


def _frame_path(root, video, frame):
    return os.path.join(root, "tthq", f"{video:02d}", f"{video:02d}_{frame:06d}.png")


def _split(samples, mode):
    """The reference's split: videos 1, 3, 10 shuffled (seed 0), val = first half."""
    np.random.RandomState(0).shuffle(samples)
    if mode == "val":
        return samples[: len(samples) // 2]
    if mode == "test":
        return samples[len(samples) // 2:]
    return samples


def _in_split(video, mode):
    return (video in VAL_TEST_VIDEOS) == (mode in ("val", "test"))


def load_tthq_ball_index(root: str, mode: str, use_invisible: bool = True) -> List[BallSample]:
    """TTHQ ball samples of a split ('train', 'val' or 'test'): every annotated frame
    whose previous and next frames exist."""
    samples = []
    for row in _rows(os.path.join(root, "tthq", "ball_detection.csv")):
        video, frame = int(float(row["video"])), int(float(row["frame"]))
        if not _in_split(video, mode):
            continue
        if not all(os.path.exists(_frame_path(root, video, f)) for f in (frame - 1, frame + 1)):
            continue
        flag = BALL_VISIBLE if int(float(row["ball_flag"])) == 2 else BALL_INVISIBLE
        if not use_invisible and flag == BALL_INVISIBLE:
            continue
        xy = (float(row["ball_x"]), float(row["ball_y"]))
        samples.append(BallSample(video, (frame, frame - 1, frame + 1), xy, flag, xy, xy))
    return _split(samples, mode)


def load_tthq_table_index(root: str, mode: str) -> List[TableSample]:
    """TTHQ table samples of a split: 13 keypoints (x, y, visibility) per frame."""
    samples = []
    for row in _rows(os.path.join(root, "tthq", "table_detection.csv")):
        video, frame = int(float(row["video"])), int(float(row["frame"]))
        if not _in_split(video, mode):
            continue
        kps = np.zeros((13, 3), np.float32)
        for k in range(13):
            kps[k, 0] = _number(row, f"point_{k + 1}_x", np.nan)
            kps[k, 1] = _number(row, f"point_{k + 1}_y", np.nan)
            flag = int(_number(row, f"point_{k + 1}_flag", 0))
            kps[k, 2] = BALL_VISIBLE if flag == 2 else BALL_INVISIBLE
        samples.append(TableSample(video, frame, kps))
    return _split(samples, mode)


def load_frame(root: str, video: int, frame: int) -> np.ndarray:
    """One RGB frame as float32 (H, W, 3) in [0, 255]: grey is repeated, alpha dropped."""
    path = _frame_path(root, video, frame)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    img = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]
    return img.astype(np.float32)


def load_ball_batch(root: str, samples: Sequence[BallSample], in_frames: int = 3):
    """(B, H, W, 3 * in_frames) windows (prev, current, next), coords (B, 3, 2) with rows
    (center, streak_min, streak_max) and visibility (B, 3)."""
    if in_frames not in (1, 3):
        raise ValueError(f"in_frames must be 1 or 3, got {in_frames}")
    imgs, coords, vis = [], [], []
    for s in samples:
        cur = load_frame(root, s.video, s.frames[0])
        if in_frames == 3:
            prev = load_frame(root, s.video, s.frames[1])
            nxt = load_frame(root, s.video, s.frames[2])
            imgs.append(np.concatenate([prev, cur, nxt], axis=-1))
        else:
            imgs.append(cur)
        coords.append([s.coords, s.min_coords, s.max_coords])
        vis.append([s.visibility] * 3)
    return np.stack(imgs), np.asarray(coords, np.float32), np.asarray(vis, np.float32)


def load_table_batch(root: str, samples: Sequence[TableSample]):
    """(B, H, W, 3) frames, keypoints (B, 13, 2) and their visibility (B, 13)."""
    imgs = [load_frame(root, s.video, s.frame) for s in samples]
    kps = np.stack([s.keypoints for s in samples])
    return np.stack(imgs), kps[..., :2], kps[..., 2]


class Prefetcher:
    """A thread that decodes the next `depth` batches while the device trains. An error
    in `make_batch` is raised in the consumer."""

    def __init__(self, make_batch, n_batches: int, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)

        def worker():
            try:
                for i in range(n_batches):
                    self.q.put(make_batch(i))
            except Exception as e:  # handed to the consumer, which raises it
                self.q.put(e)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
