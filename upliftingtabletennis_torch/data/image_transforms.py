"""Detector input normalisation, video-native ingest and the detector trainer's augmentation.

Port of `upliftingtabletennis_tpu/data/image_transforms.py` (`:32-352`). The training
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

Video-native ingest (`run_rally`): `i420_to_rgb` converts planar YUV 4:2:0 frames on
the device; `rgb_to_i420` (numpy) builds them for tests and smoke runs; `host_downscale`
resizes uint8 frames on the host before upload with the half-pixel bilinear of
`ops/resize.py` (cv2's INTER_LINEAR convention, which the JAX function calls).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops.resize import resize_bilinear_down

# ImageNet statistics (ref: data/image_transforms.py:32-33 of the JAX package)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_image", "ImageAugmentConfig",
           "draw_affine_uniforms", "sample_affines", "transform_coords", "update_visibility",
           "warp_images", "draw_jitter_uniforms", "color_jitter", "augment_detection_batch",
           "i420_to_rgb", "rgb_to_i420", "host_downscale"]


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


def draw_affine_uniforms(gen: torch.Generator, batch: int, device=None) -> torch.Tensor:
    """(8, batch) uniforms in [0, 1): flip, rotate?, angle, translate?, tx and ty (one
    draw), crop?, crop scale, ox and oy (one draw); drawn on the generator's device and
    moved to `device` (by default they stay there)."""
    return torch.rand(8, batch, generator=gen, device=gen.device).to(device or gen.device)


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


def draw_jitter_uniforms(gen: torch.Generator, batch: int, device=None) -> torch.Tensor:
    """(5, batch) uniforms in [0, 1): jitter?, brightness, contrast, saturation, hue; drawn
    on the generator's device and moved to `device` (by default they stay there)."""
    return torch.rand(5, batch, generator=gen, device=gen.device).to(device or gen.device)


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


def i420_to_rgb(frames_i420: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Planar I420 (T, height * 3 // 2, width) uint8 -> RGB (T, height, width, 3) uint8, on
    the tensor's device.

    Layout: rows [0, H) the Y plane, the next H // 4 rows the U plane ((H/2, W/2) stored
    W wide), the last H // 4 rows the V plane. Full-range BT.601, chroma upsampled by
    repetition (nearest), rounded half to even and clipped to [0, 255], as the JAX
    function computes; each product and sum is its own f32 operation, so no fused
    multiply-add changes a rounding."""
    H, W = height, width
    T = frames_i420.shape[0]
    y = frames_i420[:, :H].float()

    def chroma(rows):
        c = frames_i420[:, rows].reshape(T, H // 2, W // 2).float()
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0

    u, v = chroma(slice(H, H + H // 4)), chroma(slice(H + H // 4, H + H // 2))
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], dim=-1).round().clamp(0, 255).to(torch.uint8)


def rgb_to_i420(frames_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 (T, H, W, 3) -> planar I420 uint8 (T, H * 3 // 2, W), full-range BT.601,
    chroma box-averaged 2x2 (numpy, on the host)."""
    f = frames_rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    T, H, W = y.shape
    u2 = u.reshape(T, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    v2 = v.reshape(T, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    out = np.empty((T, H * 3 // 2, W), np.uint8)
    out[:, :H] = np.clip(np.round(y), 0, 255)
    out[:, H:H + H // 4] = np.clip(np.round(u2), 0, 255).reshape(T, H // 4, W)
    out[:, H + H // 4:] = np.clip(np.round(v2), 0, 255).reshape(T, H // 4, W)
    return out


def _resize_u8(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, h, w, C) uint8: half-pixel bilinear in f32, rounded."""
    return resize_bilinear_down(planes, h, w).round_().clamp_(0, 255).to(torch.uint8)


def host_downscale(frames: np.ndarray, dst_wh, pixel_format: str = "rgb") -> np.ndarray:
    """Bilinear downscale of uint8 frames on the host to dst_wh = (width, height), before
    upload: the detectors resize to their own input on the device anyway, so a frame
    above the largest model resolution carries only extra host-to-device bytes.

    "rgb": (T, H, W, 3). "i420": (T, H * 3 // 2, W) planar; the Y plane is resized at
    full size and U, V at half, keeping the planar layout. Returns uint8 frames in the
    same format. Within 1 grey level of cv2.resize(INTER_LINEAR), which rounds its
    fixed-point weights."""
    w, h = int(dst_wh[0]), int(dst_wh[1])
    x = torch.from_numpy(np.ascontiguousarray(frames))
    if pixel_format == "rgb":
        return _resize_u8(x, h, w).numpy()
    if pixel_format != "i420":
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    if h % 4 or w % 2:
        raise ValueError(f"i420 target resolution must have h % 4 == 0, w % 2 == 0; got {(w, h)}")
    T, H, W = x.shape[0], x.shape[1] * 2 // 3, x.shape[2]
    out = torch.empty((T, h * 3 // 2, w), dtype=torch.uint8)
    out[:, :h] = _resize_u8(x[:, :H, :, None], h, w)[..., 0]
    for src, dst in ((slice(H, H + H // 4), slice(h, h + h // 4)),
                     (slice(H + H // 4, H + H // 2), slice(h + h // 4, h + h // 2))):
        plane = x[:, src].reshape(T, H // 2, W // 2, 1)
        out[:, dst] = _resize_u8(plane, h // 2, w // 2).reshape(T, h // 4, w)
    return out.numpy()
