"""Detector input normalisation and the detector trainer's augmentation.

Port of `upliftingtabletennis_tpu/data/image_transforms.py` (`:32-273`). The training
augmentation is one composed affine warp per sample (flip, rotation about the centre,
translation, crop and resize with pixel-centre scaling), one inverse bilinear warp,
colour jitter (brightness, contrast, HSV saturation and hue) shared across the frames
of a triplet, then ImageNet normalisation. Visibility is re-evaluated at each stage's
bounds. The eval branch is a plain half-pixel bilinear resize without antialiasing.

Each random function is split into a draw and an apply: `draw_affine_uniforms` and
`draw_jitter_uniforms` take an explicit `torch.Generator` and return the uniform
numbers in [0, 1) the apply functions map, one row per JAX key of the reference, so a
test can hand JAX's draws to the port's apply. The draw structure is the JAX one,
correlations included: `tx` and `ty` come from one draw (the reference's `ks[4]`), and
so do `ox` and `oy` (`ks[7]`).

Images are float32 in [0, 255], NHWC with C = 3 * frames.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

# ImageNet statistics (ref: data/image_transforms.py:32-33 of the JAX package)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_image", "ImageAugmentConfig",
           "draw_affine_uniforms", "sample_affines", "transform_coords", "update_visibility",
           "warp_images", "draw_jitter_uniforms", "color_jitter", "augment_detection_batch"]


def normalize_image(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] NHWC with C = 3 * frames -> ImageNet-normalised, per frame."""
    B, H, W, C = images.shape
    x = images.reshape(B, H, W, C // 3, 3) / 255.0
    # per-channel Python scalars: a small constant tensor on the card would be a
    # blocking host-to-device copy that stops the host from running ahead
    x = torch.stack([(x[..., c] - IMAGENET_MEAN[c]) / IMAGENET_STD[c] for c in range(3)], -1)
    return x.reshape(B, H, W, C)


class ImageAugmentConfig(NamedTuple):
    flip_prob: float = 0.5       # 0 for the table detector
    rot_prob: float = 0.5
    max_rot_deg: float = 10.0
    transl_prob: float = 0.5
    max_transl: float = 0.2
    crop_prob: float = 0.5
    min_crop: float = 0.8
    jitter_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1


def _uniform(u, lo, hi):
    """jax.random.uniform's map of a [0, 1) draw onto [lo, hi)."""
    return torch.maximum(u * (hi - lo) + lo, torch.as_tensor(lo, dtype=u.dtype, device=u.device))


def _affine3(a, b, c, d, tx, ty):
    """Rows -> (..., 3, 3) affines [[a, b, tx], [c, d, ty], [0, 0, 1]]."""
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, b, tx], -1), torch.stack([c, d, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def draw_affine_uniforms(gen: torch.Generator, batch: int, device="cpu") -> torch.Tensor:
    """(8, batch) uniforms in [0, 1): flip, rotate?, angle, translate?, tx and ty (one
    draw), crop?, crop scale, ox and oy (one draw)."""
    return torch.rand(8, batch, generator=gen, device=gen.device).to(device)


def sample_affines(u, src_hw, dst_wh, cfg: ImageAugmentConfig, train: bool):
    """Source -> destination affines (B, 3, 3) and the stage data of visibility.

    u: the (8, B) uniforms of `draw_affine_uniforms` (unused when train is False).
    """
    H, W = src_hw
    DW, DH = dst_wh
    B = u.shape[1]
    dev = u.device
    if train:
        do_flip = u[0] < cfg.flip_prob
        do_rot = u[1] < cfg.rot_prob
        rot = torch.deg2rad(_uniform(u[2], -cfg.max_rot_deg, cfg.max_rot_deg)) * do_rot
        do_tr = u[3] < cfg.transl_prob
        tx = _uniform(u[4], -cfg.max_transl * W, cfg.max_transl * W) * do_tr
        ty = _uniform(u[4], -cfg.max_transl * H, cfg.max_transl * H) * do_tr
        do_crop = u[5] < cfg.crop_prob
        scale = torch.where(do_crop, _uniform(u[6], cfg.min_crop, 1.0), 1.0)
        crop_w = torch.round(W * scale)
        crop_h = torch.round(H * scale)
        ox = torch.floor(u[7] * (W - crop_w + 1))
        oy = torch.floor(u[7] * (H - crop_h + 1))
    else:
        zero = torch.zeros(B, device=dev)
        do_flip = torch.zeros(B, dtype=torch.bool, device=dev)
        rot, tx, ty = zero, zero, zero
        crop_w = torch.full((B,), float(W), device=dev)
        crop_h = torch.full((B,), float(H), device=dev)
        ox, oy = zero, zero
    one, zero = torch.ones(B, device=dev), torch.zeros(B, device=dev)

    # flip: x -> (W - 1) - x
    Fm = _affine3(torch.where(do_flip, -one, one), zero, zero, one,
                  torch.where(do_flip, W - 1.0, 0.0), zero)
    # rotation about (W/2, H/2), cv2's convention
    ca, sa = torch.cos(rot), torch.sin(rot)
    cx, cy = W / 2.0, H / 2.0
    R = _affine3(ca, sa, -sa, ca, (1 - ca) * cx - sa * cy, sa * cx + (1 - ca) * cy)
    T = _affine3(one, zero, zero, one, tx, ty)
    # crop, then resize with pixel-centre scaling
    C = _affine3(one, zero, zero, one, -ox, -oy)
    S = _affine3(DW / crop_w, zero, zero, DH / crop_h, 0.5 * DW / crop_w - 0.5,
                 0.5 * DH / crop_h - 0.5)
    # products grouped from the left, as the reference evaluates them
    A = S @ C @ T @ R @ Fm
    stages = {"RF": R @ Fm, "TRF": T @ R @ Fm, "CTRF": C @ T @ R @ Fm,
              "crop_wh": torch.stack([crop_w, crop_h], -1), "src_wh": (float(W), float(H))}
    return A, stages


def transform_coords(A, coords):
    """(B, 3, 3) affines applied to (B, ..., 2) coordinates."""
    h = torch.cat([coords, torch.ones_like(coords[..., :1])], -1)
    return torch.einsum("bij,b...j->b...i", A, h)[..., :2]


def update_visibility(stages, coords, visibility):
    """Visibility becomes 0 where a point leaves the frame at any stage (rotation and
    translation: [0, W) x [0, H); crop: the crop box)."""
    W, H = stages["src_wh"]

    def inside(c, w, h):
        return (c[..., 0] >= 0) & (c[..., 0] < w) & (c[..., 1] >= 0) & (c[..., 1] < h)

    ok = inside(transform_coords(stages["RF"], coords), W, H)
    ok &= inside(transform_coords(stages["TRF"], coords), W, H)
    crop = stages["crop_wh"].reshape(coords.shape[0], *([1] * (coords.ndim - 2)), 2)
    ok &= inside(transform_coords(stages["CTRF"], coords), crop[..., 0], crop[..., 1])
    return visibility * ok


def warp_images(images, A, dst_wh):
    """Inverse-warp (B, H, W, C) images through per-sample affines into (B, DH, DW, C),
    bilinear; a corner outside the image contributes 0 (`map_coordinates(order=1,
    mode="constant")`)."""
    B, H, W, C = images.shape
    DW, DH = dst_wh
    dev = images.device
    A_inv = torch.linalg.inv(A)
    gy, gx = torch.meshgrid(torch.arange(DH, dtype=torch.float32, device=dev),
                            torch.arange(DW, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones(DH * DW, device=dev)], 0)
    src = torch.einsum("bij,jn->bin", A_inv, grid)  # (B, 3, DH*DW)
    sx, sy = src[:, 0], src[:, 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx1, wy1 = sx - x0, sy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(B, H * W, C)
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))[..., None].expand(-1, -1, C)
            v = torch.where(valid[..., None], flat.gather(1, idx), 0.0)
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out.reshape(B, DH, DW, C)


def draw_jitter_uniforms(gen: torch.Generator, batch: int, device="cpu") -> torch.Tensor:
    """(5, batch) uniforms in [0, 1): jitter?, brightness, contrast, saturation, hue."""
    return torch.rand(5, batch, generator=gen, device=gen.device).to(device)


def color_jitter(u, images, cfg: ImageAugmentConfig):
    """Brightness (add), contrast (multiply), then saturation and hue in HSV, with the
    per-sample parameters of the (5, B) uniforms `u` shared across a triplet's frames."""
    B, H, W, C = images.shape
    frames = C // 3
    do = (u[0] < cfg.jitter_prob)[:, None, None, None]

    def r(row, f):
        return _uniform(u[row], -f, f)[:, None, None, None]

    x = (images.reshape(B, H, W, frames, 3) / 255.0).reshape(B, H, W * frames, 3)
    x = torch.clamp(x + r(1, cfg.brightness), 0, 1)
    x = torch.clamp(x * (1.0 + r(2, cfg.contrast)), 0, 1)

    maxc = x.max(-1).values
    minc = x.min(-1).values
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    rr, gg, bb = x[..., 0], x[..., 1], x[..., 2]
    safe = torch.clamp(delta, min=1e-12)
    h = torch.where(maxc == rr, (gg - bb) / safe,
                    torch.where(maxc == gg, 2.0 + (bb - rr) / safe, 4.0 + (rr - gg) / safe))
    h = torch.remainder(h / 6.0, 1.0)
    s = torch.clamp(s * (1.0 + r(3, cfg.saturation)[..., 0]), 0, 1)
    h = torch.remainder(h + r(4, cfg.hue)[..., 0], 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)[..., None]
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    rgb = torch.zeros_like(x)
    for k in range(5, -1, -1):  # jnp.select: the first matching case wins
        rgb = torch.where(i == k, torch.stack(choices[k], -1), rgb)
    out = rgb.reshape(B, H, W, C) * 255.0
    return torch.where(do, out, images)


def augment_detection_batch(gen, images, coords, visibility, dst_wh: Tuple[int, int],
                            cfg: ImageAugmentConfig = ImageAugmentConfig(), train: bool = True,
                            draws=None):
    """Warp, jitter and normalise a batch.

    images (B, H, W, 3 * frames) f32 in [0, 255]; coords (B, ..., 2) in source pixels;
    visibility (B, ...). Returns (images (B, DH, DW, C) normalised, coords at the
    destination resolution, visibility). `gen` draws the uniforms; `draws`, a pair of
    (8, B) and (5, B) uniforms, replaces it (tests feed JAX's draws).
    """
    B, H, W, _ = images.shape
    DW, DH = dst_wh
    if not train:
        out = F.interpolate(images.permute(0, 3, 1, 2), size=(DH, DW), mode="bilinear",
                            align_corners=False, antialias=False).permute(0, 2, 3, 1)
        sx, sy = DW / W, DH / H
        out_coords = torch.stack([(coords[..., 0] + 0.5) * sx - 0.5,
                                  (coords[..., 1] + 0.5) * sy - 0.5], -1)
        return normalize_image(out), out_coords, visibility
    if draws is None:
        draws = (draw_affine_uniforms(gen, B, images.device),
                 draw_jitter_uniforms(gen, B, images.device))
    u_aff, u_jit = draws
    A, stages = sample_affines(u_aff, (H, W), dst_wh, cfg, True)
    out = warp_images(images, A, dst_wh)
    out_coords = transform_coords(A, coords)
    visibility = update_visibility(stages, coords, visibility)
    out = color_jitter(u_jit, out, cfg)
    return normalize_image(out), out_coords, visibility
