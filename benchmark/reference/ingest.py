"""The pipeline's ingest in plain PyTorch: planar YUV 4:2:0 to RGB (full-range BT.601,
chroma repeated 2x2, rounded half to even, clipped), the half-pixel bilinear resize without
antialiasing (cv2's INTER_LINEAR convention; uint8 results rounded and clipped), and the
ImageNet normalisation the detectors take."""
from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def i420_to_rgb(frames: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(T, H * 3 // 2, W) uint8 -> (T, H, W, 3) uint8."""
    T = frames.shape[0]
    y = frames[:, :H].float()

    def chroma(lo, hi):
        c = frames[:, lo:hi].reshape(T, H // 2, W // 2).float() - 128.0
        return c.repeat_interleave(2, 1).repeat_interleave(2, 2)

    u = chroma(H, H + H // 4)
    v = chroma(H + H // 4, H + H // 2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], -1).round().clamp(0, 255).to(torch.uint8)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC (uint8 or float) -> (B, h, w, C) float32, half-pixel bilinear, no antialias."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def resize_u8(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize(x, h, w).round().clamp(0, 255).to(torch.uint8)


def downscale_i420(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Planar I420 (T, H * 3 // 2, W) -> (T, h * 3 // 2, w): Y resized at full size, U and V
    at half, each rounded to uint8."""
    T, H, W = frames.shape[0], frames.shape[1] * 2 // 3, frames.shape[2]
    out = torch.empty((T, h * 3 // 2, w), dtype=torch.uint8, device=frames.device)
    out[:, :h] = resize_u8(frames[:, :H, :, None], h, w)[..., 0]
    for (slo, shi), (dlo, dhi) in (((H, H + H // 4), (h, h + h // 4)),
                                   ((H + H // 4, H + H // 2), (h + h // 4, h + h // 2))):
        plane = frames[:, slo:shi].reshape(T, H // 2, W // 2, 1)
        out[:, dlo:dhi] = resize_u8(plane, h // 2, w // 2).reshape(T, h // 4, w)
    return out


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3 * frames) in [0, 255] -> NCHW, ImageNet-normalised per frame."""
    B, H, W, C = x.shape
    t = x.reshape(B, H, W, C // 3, 3) / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((t - mean) / std).reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
