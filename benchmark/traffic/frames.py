"""Synthetic broadcast frames, made on the device from a seed: a textured background with a
fixed grain, a little sensor noise per frame, and a bright Gaussian blob (the ball) on a
bouncing flight. The pattern of `chip_smoke.py`'s `synthetic_frames`, driven by the seed.

Frames come back to the host as one uint8 array, RGB (T, H, W, 3) or planar I420
(T, H * 3 // 2, W) converted on the device (full-range BT.601, chroma averaged 2x2, rounded
half to even and clipped, as a decoder's output).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 16  # frames rendered per device call


def ball_track(rng: np.random.Generator, n: int, W: int, H: int, p: dict) -> np.ndarray:
    """(n, 2) ball centres: flights across the frame that bounce off the table line and the
    frame's sides, each flight's speed and height drawn from `rng`."""
    out = np.empty((n, 2), np.float64)
    margin = 0.05 * W
    x, vx = rng.uniform(margin, W - margin), rng.choice([-1, 1]) * rng.uniform(*p["speed_px"])
    t0, period, height, floor = 0, rng.integers(*p["bounce_frames"]), rng.uniform(*p["height"]), \
        rng.uniform(0.55, 0.75) * H
    for t in range(n):
        if t - t0 >= period:
            t0, period = t, rng.integers(*p["bounce_frames"])
            height = rng.uniform(*p["height"])
        x += vx
        if x < margin or x > W - margin:
            vx, x = -vx, min(max(x, margin), W - margin)
        phase = (t - t0) / period
        out[t] = (x, floor - 4.0 * height * H * phase * (1.0 - phase))
    return out


def _render(gen, bg, centres, p, device):
    """Frames (B, H, W, 3) float on the device: background, per-frame noise, the blob."""
    B = len(centres)
    H, W = bg.shape[:2]
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    c = torch.as_tensor(centres, dtype=torch.float32, device=device)
    d2 = (xx[None] - c[:, 0, None, None]) ** 2 + (yy[None] - c[:, 1, None, None]) ** 2
    blob = p["ball_level"] * torch.exp(-d2 / (2.0 * p["ball_sigma_px"] ** 2))
    noise = torch.randn((B, H, W, 3), generator=gen, device=device) * p["noise"]
    return (bg[None] + noise + blob[..., None]).clamp_(0, 255)


def to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) float in [0, 255] -> planar I420 uint8 (T, H * 3 // 2, W)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    T, H, W = y.shape
    u2 = u.reshape(T, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    v2 = v.reshape(T, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    out = torch.empty((T, H * 3 // 2, W), dtype=torch.uint8, device=rgb.device)
    out[:, :H] = y.round().clamp(0, 255).to(torch.uint8)
    out[:, H:H + H // 4] = u2.round().clamp(0, 255).to(torch.uint8).reshape(T, H // 4, W)
    out[:, H + H // 4:] = v2.round().clamp(0, 255).to(torch.uint8).reshape(T, H // 4, W)
    return out


def frame_pool(seed: int, n: int, wh, p: dict, pixel_format: str, device) -> np.ndarray:
    """`n` consecutive frames of one synthetic video, the same for the same seed."""
    W, H = int(wh[0]), int(wh[1])
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng([seed, 1])
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :, None]
    coarse = torch.rand((1, 3, max(H // 16, 2), max(W // 16, 2)), generator=gen, device=device)
    texture = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)[0]
    bg = (p["base_level"] + 40.0 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0)
          + 60.0 * (texture.permute(1, 2, 0) - 0.5)
          + torch.randn((H, W, 3), generator=gen, device=device) * p["grain"])
    track = ball_track(rng, n, W, H, p)
    shape = (n, H, W, 3) if pixel_format == "rgb" else (n, H * 3 // 2, W)
    out = np.empty(shape, np.uint8)
    for s in range(0, n, BATCH):
        frames = _render(gen, bg, track[s:s + BATCH], p, device)
        part = frames.round().to(torch.uint8) if pixel_format == "rgb" else to_i420(frames)
        out[s:s + len(part)] = part.cpu().numpy()
    return out
