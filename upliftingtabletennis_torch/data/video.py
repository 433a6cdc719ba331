"""Video ingest: decode footage into the pipeline's input formats.

Port of `upliftingtabletennis_tpu/data/video.py`. The pipeline takes RGB uint8 frames or
planar I420 (`TableTennisPipeline.predict(..., pixel_format="i420")`); decoders emit YUV,
so the I420 path skips the host's RGB conversion. Decoding is OpenCV's
(`cv2.VideoCapture`), imported inside each function: an mp4 decoder has no numpy
substitute, and nothing else of the port needs OpenCV.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["read_video", "video_info", "iter_video_chunks"]


def read_video(path: str, start: int = 0, end: Optional[int] = None,
               pixel_format: str = "rgb") -> np.ndarray:
    """Frames [start, end) of a video file: (T, H, W, 3) uint8 RGB, or (T, H * 3 // 2, W)
    uint8 planar I420 with pixel_format "i420"."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    code = cv2.COLOR_BGR2YUV_I420 if pixel_format == "i420" else cv2.COLOR_BGR2RGB
    frames = []
    idx = start
    while end is None or idx < end:
        ret, bgr = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(bgr, code))
        idx += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path} in [{start}, {end})")
    return np.stack(frames)


def video_info(path: str) -> Tuple[int, int, int, float]:
    """(num_frames, height, width, fps) of a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return n, h, w, fps


def iter_video_chunks(path: str, chunk: int = 256,
                      pixel_format: str = "rgb") -> Iterator[np.ndarray]:
    """A long video in chunks of `chunk` frames (bounded host memory)."""
    n, _, _, _ = video_info(path)
    for s in range(0, n, chunk):
        yield read_video(path, s, min(s + chunk, n), pixel_format)
