"""Synthetic broadcast frames of a rally, for the closed-loop protocol (`eval/closed_loop.py`).

Port of `upliftingtabletennis_tpu/data/render_rally.py`: physics trajectories projected
through a camera are drawn into video-like frames (an arena gradient, a floor quad and
two asymmetric markers on it, the table quad with white lines along the reference's
13-keypoint topology, a Gaussian ball blob, sensor noise). The JAX package fuses the
renderer in XLA; here it is plain PyTorch on the device of its inputs (no kernel: there
is no Pallas counterpart). Each quad, line and ball blob is computed on the window of
pixels it can reach, with the full frame's arithmetic per pixel. The pixel tests are knife edges
(`d2 < line_w2`, the signs of the cross products), so they are computed in the JAX
function's order of f32 operations. The sensor noise is an argument, or is drawn from
a `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from upliftingtabletennis_torch.core.geometry import TABLE_CONNECTIONS, world2img

__all__ = ["CONTEXT_QUADS_WORLD", "project_context", "render_frames", "rescale_px"]

# the table surface's quad in TABLE_POINTS indices (close-left, close-right, far-right,
# far-left)
_QUAD = (0, 1, 5, 4)
BLOB_RADIUS = 9.0  # 185 exp(-81 / 2) < 5e-16

# World-anchored scene context on the floor (z = 0): a court quad and two small
# asymmetric markers, an umpire table on the +y side of the net and a banner past the
# +x end. The bare table and net are mirror-symmetric across the net plane and the long
# centre line; the markers make the corners' identities decidable from the image.
CONTEXT_QUADS_WORLD = np.array(
    [
        [[-4.5, -3.0, 0], [4.5, -3.0, 0], [4.5, 3.0, 0], [-4.5, 3.0, 0]],  # floor
        [[-0.5, 1.5, 0], [0.5, 1.5, 0], [0.5, 2.3, 0], [-0.5, 2.3, 0]],  # umpire +y
        [[2.2, -0.6, 0], [3.2, -0.6, 0], [3.2, 0.6, 0], [2.2, 0.6, 0]],  # banner +x
    ],
    dtype=np.float32,
)


def project_context(Mint: torch.Tensor, Mext: torch.Tensor) -> torch.Tensor:
    """CONTEXT_QUADS_WORLD through cameras Mint (..., 3, 3), Mext (..., 4, 4) -> (..., 3,
    4, 2) pixels at the resolution Mint is expressed in."""
    pts = torch.as_tensor(CONTEXT_QUADS_WORLD.reshape(12, 3), device=Mext.device)
    pts = pts.expand(*Mext.shape[:-2], 12, 3)
    px = world2img(pts, Mext, Mint)
    return px.reshape(*px.shape[:-2], 3, 4, 2)


def _seg_dist2(px, py, a, b):
    """Squared distance of every pixel to the segment a-b. px, py (H, W); a, b (2,)."""
    d = b - a
    len2 = torch.clamp_min(d[0] * d[0] + d[1] * d[1], 1e-6)
    t = ((px - a[0]) * d[0] + (py - a[1]) * d[1]) / len2
    t = torch.clamp(t, 0.0, 1.0)
    cx = a[0] + t * d[0]
    cy = a[1] + t * d[1]
    return (px - cx) ** 2 + (py - cy) ** 2


def _inside_quad(px, py, quad):
    """Point in a convex quad (4, 2): the four cross products share a sign."""
    inside_pos = torch.ones_like(px, dtype=torch.bool)
    inside_neg = torch.ones_like(px, dtype=torch.bool)
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        cross = (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])
        inside_pos &= cross >= 0
        inside_neg &= cross <= 0
    return inside_pos | inside_neg


def _window(pts, margin: float, height: int, width: int):
    """(rows, cols) slices of the pixels within `margin` of the bounding box of pts (host
    floats (x, y)), or the whole frame when a coordinate is not finite. No pixel outside
    a quad's bounding box passes `_inside_quad` (its four signs then disagree), and none
    farther than the line width from a segment passes the line test, so both tests run
    on the window alone, with the same arithmetic per pixel."""
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    if not all(math.isfinite(v) for v in xs + ys):
        return slice(0, height), slice(0, width)
    x0 = min(max(math.floor(min(xs) - margin), 0), width)
    x1 = min(max(math.ceil(max(xs) + margin) + 1, x0), width)
    y0 = min(max(math.floor(min(ys) - margin), 0), height)
    y1 = min(max(math.ceil(max(ys) + margin) + 1, y0), height)
    return slice(y0, y1), slice(x0, x1)


def _quad_mask(xx, yy, quad, quad_host):
    """`_inside_quad` over the frame, computed on the quad's window."""
    H, W = xx.shape
    win = _window(quad_host, 0.0, H, W)
    mask = torch.zeros_like(xx, dtype=torch.bool)
    mask[win] = _inside_quad(xx[win], yy[win], quad)
    return mask


def render_frames(ball_px: torch.Tensor, ball_vis: torch.Tensor, table_px: torch.Tensor,
                  height: int = 1080, width: int = 1920,
                  context_px: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Render a batch of frames of one static camera, on ball_px's device.

    ball_px (B, 2) ball pixels; ball_vis (B,) in {0, 1}; table_px (13, 2) projected table
    keypoints; context_px (3, 4, 2) projected CONTEXT_QUADS_WORLD (`project_context`) or
    None for the bare scene; noise (B, height, width) standard normal draws, or None to
    draw them from `generator`. -> (B, height, width, 3) uint8."""
    dev = ball_px.device
    f32 = torch.float32
    ball_px, ball_vis, table_px = (t.to(dev, f32) for t in (ball_px, ball_vis, table_px))
    B = ball_px.shape[0]
    yy, xx = torch.meshgrid(torch.arange(height, device=dev, dtype=f32),
                            torch.arange(width, device=dev, dtype=f32), indexing="ij")

    table_host = table_px.tolist()  # for the windows only

    # the arena's background gradient
    frame = 70.0 + 60.0 * (xx / width) + 40.0 * (yy / height)
    side_m = end_m = None
    if context_px is not None:
        context_px = context_px.to(dev, f32)
        ctx_host = context_px.tolist()
        # drawn in depth order: the floor, the markers on it, then the table above it
        frame = torch.where(_quad_mask(xx, yy, context_px[0], ctx_host[0]), 58.0, frame)
        side_m = _quad_mask(xx, yy, context_px[1], ctx_host[1])
        end_m = _quad_mask(xx, yy, context_px[2], ctx_host[2])
        frame = torch.where(side_m, 150.0, frame)
        frame = torch.where(end_m, 140.0, frame)

    # the table surface and its white lines
    table_mask = _quad_mask(xx, yy, table_px[list(_QUAD)], [table_host[i] for i in _QUAD])
    frame = torch.where(table_mask, 45.0, frame)
    line_w = 0.0015 * width  # ~3 px at 1920
    line_w2 = torch.tensor(line_w ** 2, dtype=f32, device=dev)
    for a_i, b_i in TABLE_CONNECTIONS:
        win = _window([table_host[a_i], table_host[b_i]], line_w + 2.0, height, width)
        d2 = _seg_dist2(xx[win], yy[win], table_px[a_i], table_px[b_i])
        frame[win] = torch.where(d2 < line_w2, 230.0, frame[win])
    if context_px is not None:  # the markers keep their colour where the table is not
        side_m = side_m & ~table_mask
        end_m = end_m & ~table_mask

    # each frame's ball blob (sigma: the label heatmap's 6 px at 1920) and sensor noise.
    # Beyond BLOB_RADIUS sigmas the blob is below half an ulp of the frame (>= 45), so
    # frame + blob is the frame there: the blob is added on its window alone.
    sigma = 6.0 * width / 1920.0
    out = frame[None].repeat(B, 1, 1)
    ball_host = ball_px.tolist()
    for i in range(B):
        win = _window([ball_host[i]], BLOB_RADIUS * sigma, height, width)
        d2b = (xx[win] - ball_px[i, 0]) ** 2 + (yy[win] - ball_px[i, 1]) ** 2
        blob = 185.0 * torch.exp(-d2b / (2.0 * sigma ** 2)) * ball_vis[i]
        out[i][win] = out[i][win] + blob
    if noise is None:
        noise = torch.randn((B, height, width), generator=generator, device=dev)
    out = torch.clamp(out + 2.0 * noise.to(dev, f32), 0.0, 255.0)
    # a mild channel tint, so the frames are not grey
    r = out
    g = out * 0.97 + 3.0
    b = out * 0.94 + 5.0
    if context_px is not None:  # the umpire quad reddish, the banner bluish
        s, e = side_m.to(f32), end_m.to(f32)
        r = r + 45.0 * s - 35.0 * e
        g = g - 25.0 * s - 10.0 * e
        b = b - 35.0 * s + 50.0 * e
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


def rescale_px(coords, src_wh, dst_wh) -> torch.Tensor:
    """Pixel-centre rescale (x + 0.5) * s - 0.5 of coordinates (..., 2), in f32."""
    coords = torch.as_tensor(coords, dtype=torch.float32)
    sx = dst_wh[0] / src_wh[0]
    sy = dst_wh[1] / src_wh[1]
    return torch.stack([(coords[..., 0] + 0.5) * sx - 0.5, (coords[..., 1] + 0.5) * sy - 0.5], -1)
