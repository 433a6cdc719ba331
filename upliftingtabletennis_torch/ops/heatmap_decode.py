"""Keypoints from heatmaps (argmax + quarter shift or DARK), and the flip test.

Port of `upliftingtabletennis_tpu/ops/heatmap_decode.py`:

- `keypoints_from_heatmaps` decodes (B, K, H, W) heatmaps, the mmpose
  post-processing of ViTPose: per channel the first argmax, then either the
  quarter-pixel shift toward the larger neighbour ('default') or the DARK
  Taylor refinement on the log of a Gaussian-blurred map ('unbiased'). All
  B * K channels are decoded at once, with no loop per channel.
- `flip_back` and `flip_test_heatmaps` average a forward pass with one on
  mirrored input. Their heatmaps and images are NHWC, as in the JAX functions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["keypoints_from_heatmaps", "flip_back", "flip_test_heatmaps"]


def _argmax_2d(hm: torch.Tensor):
    """(N, H, W) -> x, y (N,) int64 of each map's first maximum, and the maximum."""
    W = hm.shape[-1]
    idx = hm.flatten(1).argmax(dim=1)  # the first index of the maximum, as jnp.argmax
    return idx % W, idx // W, hm.flatten(1).gather(1, idx[:, None])[:, 0]


def _gaussian_blur(hm: torch.Tensor, kernel: int) -> torch.Tensor:
    """Separable Gaussian blur of (N, H, W) maps over zero padding, each map then
    rescaled so that its maximum keeps its value (the JAX function's convention)."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = kernel // 2
    x = torch.arange(-r, r + 1, dtype=hm.dtype, device=hm.device)
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    orig_max = hm.flatten(1).max(dim=1).values
    out = F.conv2d(hm[:, None], g.view(1, 1, 1, -1), padding=(0, r))
    out = F.conv2d(out, g.view(1, 1, -1, 1), padding=(r, 0))[:, 0]
    new_max = out.flatten(1).max(dim=1).values.clamp_min(1e-10)
    return out * (orig_max / new_max)[:, None, None]


def _sampler(hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """val(dy, dx): hm[n, y + dy, x + dx] per map n, indices clipped into the map."""
    N, H, W = hm.shape
    flat = hm.flatten(1)

    def val(dy: int, dx: int) -> torch.Tensor:
        yy = (y + dy).clamp(0, H - 1)
        xx = (x + dx).clamp(0, W - 1)
        return flat.gather(1, (yy * W + xx)[:, None])[:, 0]

    return val


def _dark_refine(hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """DARK: the second-order Taylor offset of the log map at the integer peak (x, y),
    clipped to one pixel; none within two pixels of the border or at a flat Hessian."""
    _, H, W = hm.shape
    val = _sampler(torch.log(hm.clamp_min(1e-10)), x, y)
    dx = 0.5 * (val(0, 1) - val(0, -1))
    dy = 0.5 * (val(1, 0) - val(-1, 0))
    dxx = 0.25 * (val(0, 2) - 2 * val(0, 0) + val(0, -2))
    dyy = 0.25 * (val(2, 0) - 2 * val(0, 0) + val(-2, 0))
    dxy = 0.25 * (val(1, 1) - val(-1, 1) - val(1, -1) + val(-1, -1))
    det = dxx * dyy - dxy * dxy
    flat = det.abs() > 1e-12
    inside = (x > 1) & (x < W - 2) & (y > 1) & (y < H - 2) & flat
    inv_det = torch.where(flat, 1.0 / det, torch.zeros_like(det))
    ox = -(dyy * dx - dxy * dy) * inv_det  # -H^-1 grad
    oy = -(-dxy * dx + dxx * dy) * inv_det
    zero = torch.zeros_like(ox)
    return (x + torch.where(inside, ox.clamp(-1.0, 1.0), zero),
            y + torch.where(inside, oy.clamp(-1.0, 1.0), zero))


def _default_refine(hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """A quarter pixel toward the larger neighbour on each axis, away from the border."""
    _, H, W = hm.shape
    val = _sampler(hm, x, y)
    sx = torch.sign(val(0, 1) - val(0, -1))
    sy = torch.sign(val(1, 0) - val(-1, 0))
    inside = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
    zero = torch.zeros_like(sx)
    return x + torch.where(inside, 0.25 * sx, zero), y + torch.where(inside, 0.25 * sy, zero)


def keypoints_from_heatmaps(heatmaps: torch.Tensor, post_process: str = "default",
                            kernel: int = 11):
    """Decode (B, K, H, W) heatmaps -> (coords (B, K, 2) f32 (x, y), maxvals (B, K, 1)).

    post_process: 'default' (quarter shift) or 'unbiased' (DARK with a `kernel`-wide
    blur). Coordinates are in heatmap pixels, -1 where the maximum is not positive.
    """
    if post_process not in ("default", "unbiased"):
        raise ValueError(f"unknown post_process {post_process!r}")
    B, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(B * K, H, W)
    x, y, maxval = _argmax_2d(flat)
    if post_process == "unbiased":
        fx, fy = _dark_refine(_gaussian_blur(flat, kernel), x, y)
    else:
        fx, fy = _default_refine(flat, x, y)
    valid = maxval > 0
    coords = torch.stack([torch.where(valid, fx, torch.full_like(fx, -1.0)),
                          torch.where(valid, fy, torch.full_like(fy, -1.0))], dim=-1)
    return coords.float().reshape(B, K, 2), maxval.reshape(B, K, 1)


def flip_back(heatmaps: torch.Tensor, flip_pairs=(), shift: bool = True) -> torch.Tensor:
    """Un-flip heatmaps (B, h, w, C) predicted on horizontally flipped inputs.

    flip_pairs: (a, b) channel pairs that swap identity under mirroring
    (empty for the single ball channel). shift: move the un-flipped maps one
    pixel right, the alignment fix of the reference's 'shift_heatmap'.
    """
    out = torch.flip(heatmaps, dims=(2,))
    if flip_pairs:
        idx = list(range(out.shape[-1]))
        for a, b in flip_pairs:
            idx[a], idx[b] = idx[b], idx[a]
        out = out[..., idx]
    if shift:
        out = torch.cat([out[:, :, :1], out[:, :, :-1]], dim=2)
    return out


def flip_test_heatmaps(apply_fn, images: torch.Tensor, flip_pairs=(),
                       shift: bool = True) -> torch.Tensor:
    """0.5 * (apply_fn(images) + flip_back(apply_fn(mirrored images))).

    apply_fn: images (B, H, W, C_in) -> heatmaps (B, h, w, C_out), both NHWC.
    """
    heat = apply_fn(images)
    heat_f = apply_fn(torch.flip(images, dims=(2,)))
    return 0.5 * (heat + flip_back(heat_f, flip_pairs, shift))
