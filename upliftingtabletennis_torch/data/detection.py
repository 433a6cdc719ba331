"""Detection datasets (TTHQ and BlurBall): sample indices, frame batches and a threaded
prefetcher.

Port of `upliftingtabletennis_tpu/data/detection.py`. Host-side readers produce raw frames
and annotations; augmentation, targets and the loss run on the device
(`data/image_transforms.py`, `eval/metrics.py`). CSVs are read with the standard library
and frames decoded by `data/png.py` (no pandas, no cv2).

TTHQ:
* ball: `<root>/tthq/ball_detection.csv` (sep ';', columns video, frame, ball_x, ball_y,
  ball_flag; flag 2 = visible) and frames `<root>/tthq/<video:02d>/<video:02d>_<frame:06d>.png`;
* table: `table_detection.csv` with 13 keypoints per frame (point_<k>_x/_y/_flag).
Videos 1, 3 and 10 are the val + test pool, shuffled with numpy's RandomState(0) and
split in halves.

BlurBall (the pretraining set):
* ball: frames `<root>/blurball/<vid:02d>/frames/<seq:03d>/<frame:05d>.png` and, per
  sequence, `<root>/blurball/all_csv_annotations/<vid:02d>_csv_<seq:03d>.csv` (sep ',',
  columns Frame, X, Y, l, theta, Visibility): the ball centre and its blur streak's
  half-length and angle in degrees;
* table: the same frames, the 13 keypoints projected through the per-video calibration
  `<root>/blurball/all_calib_files/<vid:02d>_table_pose.yaml` (rvec, tvec, f).
Videos 3, 6, 8, 15, 20, 22 and 24 are the val + test pool, shuffled and halved as TTHQ's
(the table's val half thinned 10x).
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
           "load_ball_batch", "load_table_batch", "BlurBallSample", "load_blurball_index",
           "blur_streak_endpoints", "load_frame_path", "load_blurball_ball_batch",
           "BlurBallTableSample", "blurball_table_keypoints", "load_blurball_table_index",
           "load_blurball_table_batch", "Prefetcher"]

BALL_VISIBLE = 1
BALL_INVISIBLE = 0
EVAL_WIDTH, EVAL_HEIGHT = 1920, 1080  # metric resolution
VAL_TEST_VIDEOS = (1, 3, 10)
BLURBALL_HOLDOUT = (3, 6, 8, 15, 20, 22, 24)
BLURBALL_VIDEOS = 26


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


def _rows(path, delimiter=";"):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=delimiter))


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


def load_frame_path(path: str) -> np.ndarray:
    """One RGB frame as float32 (H, W, 3) in [0, 255]: grey is repeated, alpha dropped."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    img = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]
    return img.astype(np.float32)


def load_frame(root: str, video: int, frame: int) -> np.ndarray:
    """One TTHQ frame (`load_frame_path`)."""
    return load_frame_path(_frame_path(root, video, frame))


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


class BlurBallSample(NamedTuple):
    paths: Tuple[str, str, str]  # (current, prev, next) frame paths
    coords: Tuple[float, float]
    blur_len: float
    blur_theta_deg: float
    visibility: int


def _blurball_videos(mode):
    return [v for v in range(BLURBALL_VIDEOS) if (v in BLURBALL_HOLDOUT) == (mode != "train")]


def load_blurball_index(root: str, mode: str, use_invisible: bool = True) -> List[BlurBallSample]:
    """BlurBall ball samples of a split: every frame of a sequence whose neighbours are
    frames too and whose three frames are all annotated; with use_invisible False, none of
    the three may be invisible."""
    data_path = os.path.join(root, "blurball")
    ann_path = os.path.join(data_path, "all_csv_annotations")
    samples: List[BlurBallSample] = []
    for vid in _blurball_videos(mode):
        frames_root = os.path.join(data_path, f"{vid:02d}", "frames")
        if not os.path.isdir(frames_root):
            continue
        for seq in sorted(int(s) for s in os.listdir(frames_root) if s.isdecimal()):
            seq_path = os.path.join(frames_root, f"{seq:03d}")
            ann = os.path.join(ann_path, f"{vid:02d}_csv_{seq:03d}.csv")
            if not os.path.exists(ann):
                continue
            by_frame = {int(float(r["Frame"])): r for r in _rows(ann, ",")}
            frames = sorted(int(f[:-4]) for f in os.listdir(seq_path) if f.endswith(".png"))
            for i in range(1, len(frames) - 1):
                f, fp, fn = frames[i], frames[i - 1], frames[i + 1]
                if f not in by_frame or fp not in by_frame or fn not in by_frame:
                    continue
                flags = [BALL_VISIBLE if int(float(by_frame[k]["Visibility"])) != 0
                         else BALL_INVISIBLE for k in (f, fp, fn)]
                if not use_invisible and BALL_INVISIBLE in flags:
                    continue
                r = by_frame[f]
                samples.append(BlurBallSample(
                    tuple(os.path.join(seq_path, f"{k:05d}.png") for k in (f, fp, fn)),
                    (float(r["X"]), float(r["Y"])), float(r["l"]), float(r["theta"]), flags[0]))
    return _split(samples, mode)


def blur_streak_endpoints(coords_eval, blur_len, theta_deg, src_wh):
    """The blur streak's min and max endpoints at the evaluation resolution, clamped to the
    image. coords_eval: the ball centre already at (EVAL_WIDTH, EVAL_HEIGHT); blur_len and
    theta annotated at the source resolution src_wh."""
    sx = EVAL_WIDTH / src_wh[0]
    sy = EVAL_HEIGHT / src_wh[1]
    dx = blur_len * np.cos(np.deg2rad(theta_deg)) * sx
    dy = blur_len * np.sin(np.deg2rad(theta_deg)) * sy
    x, y = coords_eval
    min_pt = (max(0.0, x - dx), max(0.0, y - dy))
    max_pt = (min(EVAL_WIDTH - 1.0, x + dx), min(EVAL_HEIGHT - 1.0, y + dy))
    return min_pt, max_pt


def load_blurball_ball_batch(root: str, samples: Sequence[BlurBallSample], in_frames: int = 3):
    """(B, H, W, 3 * in_frames) windows (prev, current, next), coords (B, 3, 2) at the
    source resolution with rows (centre, streak_min, streak_max), the streak's ends
    clamped to the frame, and visibility (B, 3). `root` is unused (the samples hold
    their paths), kept for the loaders' common signature."""
    if in_frames not in (1, 3):
        raise ValueError(f"in_frames must be 1 or 3, got {in_frames}")
    imgs, coords, vis = [], [], []
    for s in samples:
        cur = load_frame_path(s.paths[0])
        if in_frames == 3:
            prev = load_frame_path(s.paths[1])
            nxt = load_frame_path(s.paths[2])
            imgs.append(np.concatenate([prev, cur, nxt], axis=-1))
        else:
            imgs.append(cur)
        x, y = s.coords
        dx = s.blur_len * np.cos(np.deg2rad(s.blur_theta_deg))
        dy = s.blur_len * np.sin(np.deg2rad(s.blur_theta_deg))
        H, W = cur.shape[:2]
        mn = (max(0.0, x - dx), max(0.0, y - dy))
        mx = (min(W - 1.0, x + dx), min(H - 1.0, y + dy))
        coords.append([(x, y), mn, mx])
        vis.append([s.visibility] * 3)
    return np.stack(imgs), np.asarray(coords, np.float32), np.asarray(vis, np.float32)


class BlurBallTableSample(NamedTuple):
    path: str
    keypoints: np.ndarray  # (13, 3) x, y, visibility at the source resolution


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def blurball_table_keypoints(camera_info: dict, orig_wh: Tuple[int, int]) -> np.ndarray:
    """The 13 table keypoints (13, 3) [x, y, visible] at the source resolution: TABLE_POINTS
    through a BlurBall calibration (Rodrigues(rvec) and tvec, right-multiplied by the
    change from this package's world frame to the calibration's; focal f, the principal
    point at ((W - 1) / 2, (H - 1) / 2)), in float64."""
    from upliftingtabletennis_torch.core.geometry import TABLE_HEIGHT, TABLE_POINTS

    W, H = orig_wh
    rvec = np.asarray(camera_info["rvec"], np.float64).ravel()
    tvec = np.asarray(camera_info["tvec"], np.float64).ravel()
    f = float(camera_info["f"])
    Mint = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]])
    Mext = np.eye(4)
    Mext[:3, :3] = _rodrigues(rvec)
    Mext[:3, 3] = tvec
    trans = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, -TABLE_HEIGHT], [0, 0, 0, 1]],
                     np.float64)
    Mext = Mext @ trans
    tp = np.concatenate([np.asarray(TABLE_POINTS, np.float64), np.ones((13, 1))], -1)
    cam_pts = (Mext @ tp.T).T
    img_pts = (Mint @ (cam_pts[:, :3] / cam_pts[:, 3:4]).T).T
    xy = img_pts[:, :2] / img_pts[:, 2:3]
    return np.concatenate([xy, np.full((13, 1), BALL_VISIBLE, np.float64)], -1).astype(
        np.float32)


def _png_size(path: str) -> Tuple[int, int]:
    """(W, H) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def load_blurball_table_index(root: str, mode: str) -> List[BlurBallTableSample]:
    """BlurBall table samples of a split: every frame of every sequence of a video that
    has a calibration, its keypoints from it (static cameras: one set per video, the
    resolution read from the first frame). val: the first shuffled half thinned 10x; test:
    the second half."""
    import yaml

    data_path = os.path.join(root, "blurball")
    samples: List[BlurBallTableSample] = []
    for vid in _blurball_videos(mode):
        frames_root = os.path.join(data_path, f"{vid:02d}", "frames")
        calib = os.path.join(data_path, "all_calib_files", f"{vid:02d}_table_pose.yaml")
        if not os.path.isdir(frames_root) or not os.path.exists(calib):
            continue
        with open(calib) as f:
            camera_info = yaml.safe_load(f)
        kps = None
        for seq in sorted(s for s in os.listdir(frames_root) if s.isdecimal()):
            seq_path = os.path.join(frames_root, seq)
            for fname in sorted(f for f in os.listdir(seq_path) if f.endswith(".png")):
                path = os.path.join(seq_path, fname)
                if kps is None:
                    kps = blurball_table_keypoints(camera_info, _png_size(path))
                samples.append(BlurBallTableSample(path, kps))
    np.random.RandomState(0).shuffle(samples)
    if mode == "val":
        return samples[: len(samples) // 2][::10]
    if mode == "test":
        return samples[len(samples) // 2:]
    return samples


def load_blurball_table_batch(root: str, samples: Sequence[BlurBallTableSample]):
    """(B, H, W, 3) frames, keypoints (B, 13, 2) and their visibility (B, 13)."""
    imgs = [load_frame_path(s.path) for s in samples]
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
