"""The ball detector's training step in plain float32 PyTorch, as the reference trainer
defines it: the augmentation (one affine warp per sample, then colour jitter shared by a
triplet's frames), Gaussian targets at the evaluation resolution, the weighted MSE on the
logits resized bilinearly to it, optax's clip_by_global_norm then Adam, and the EMA of the
parameters. The uniform draws are handed in (the benchmark takes them from the same
generator state the program's step drew from).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def _uniform(u, lo, hi):
    return torch.maximum(u * (hi - lo) + lo, torch.as_tensor(lo, dtype=u.dtype, device=u.device))


def _affine(a, b, c, d, tx, ty):
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, b, tx], -1), torch.stack([c, d, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def affines(u, src_hw, dst_wh, aug):
    """Source -> destination affines (B, 3, 3) and the stages that decide visibility:
    flip, rotation about the centre, translation, a crop, and its resize by pixel centres."""
    H, W = src_hw
    DW, DH = dst_wh
    B = u.shape[1]
    dev = u.device
    flip = u[0] < aug["flip_prob"]
    rot = torch.deg2rad(_uniform(u[2], -aug["max_rot_deg"], aug["max_rot_deg"])) \
        * (u[1] < aug["rot_prob"])
    do_tr = u[3] < aug["transl_prob"]
    tx = _uniform(u[4], -aug["max_transl"] * W, aug["max_transl"] * W) * do_tr
    ty = _uniform(u[4], -aug["max_transl"] * H, aug["max_transl"] * H) * do_tr
    scale = torch.where(u[5] < aug["crop_prob"], _uniform(u[6], aug["min_crop"], 1.0), 1.0)
    cw, ch = torch.round(W * scale), torch.round(H * scale)
    ox, oy = torch.floor(u[7] * (W - cw + 1)), torch.floor(u[7] * (H - ch + 1))
    one, zero = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    Fm = _affine(torch.where(flip, -one, one), zero, zero, one, torch.where(flip, W - 1.0, 0.0),
                 zero)
    ca, sa = torch.cos(rot), torch.sin(rot)
    cx, cy = W / 2.0, H / 2.0
    R = _affine(ca, sa, -sa, ca, (1 - ca) * cx - sa * cy, sa * cx + (1 - ca) * cy)
    T = _affine(one, zero, zero, one, tx, ty)
    C = _affine(one, zero, zero, one, -ox, -oy)
    S = _affine(DW / cw, zero, zero, DH / ch, 0.5 * DW / cw - 0.5, 0.5 * DH / ch - 0.5)
    A = S @ C @ T @ R @ Fm
    return A, {"RF": R @ Fm, "TRF": T @ R @ Fm, "CTRF": C @ T @ R @ Fm,
               "crop": torch.stack([cw, ch], -1), "src": (float(W), float(H))}


def apply(A, xy):
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    return torch.einsum("bij,b...j->b...i", A, h)[..., :2]


def visibility(stages, xy, vis):
    W, H = stages["src"]

    def inside(c, w, h):
        return (c[..., 0] >= 0) & (c[..., 0] < w) & (c[..., 1] >= 0) & (c[..., 1] < h)

    ok = inside(apply(stages["RF"], xy), W, H) & inside(apply(stages["TRF"], xy), W, H)
    crop = stages["crop"].reshape(xy.shape[0], *([1] * (xy.ndim - 2)), 2)
    ok &= inside(apply(stages["CTRF"], xy), crop[..., 0], crop[..., 1])
    return vis * ok


def warp(images, A, dst_wh):
    """Inverse bilinear warp of (B, H, W, C) images; corners outside the image give 0."""
    B, H, W, C = images.shape
    DW, DH = dst_wh
    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(DH, dtype=torch.float32, device=dev),
                            torch.arange(DW, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones(DH * DW, device=dev)])
    src = torch.einsum("bij,jn->bin", torch.linalg.inv(A), grid)
    sx, sy = src[:, 0], src[:, 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx1, wy1 = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(B, H * W, C)
    out = 0
    for yi, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for xi, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))[..., None].expand(-1, -1, C)
            out = out + (wy * wx)[..., None] * torch.where(ok[..., None], flat.gather(1, idx), 0.0)
    return out.reshape(B, DH, DW, C)


def jitter(u, images, aug):
    """Brightness, contrast, then saturation and hue in HSV, one draw per sample."""
    B, H, W, C = images.shape
    do = (u[0] < aug["jitter_prob"])[:, None, None, None]

    def r(row, f):
        return _uniform(u[row], -f, f)[:, None, None, None]

    x = (images.reshape(B, H, W, C // 3, 3) / 255.0).reshape(B, H, W * (C // 3), 3)
    x = torch.clamp(x + r(1, aug["brightness"]), 0, 1)
    x = torch.clamp(x * (1.0 + r(2, aug["contrast"])), 0, 1)
    maxc, minc = x.max(-1).values, x.min(-1).values
    v, delta = maxc, maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    rr, gg, bb = x[..., 0], x[..., 1], x[..., 2]
    safe = torch.clamp(delta, min=1e-12)
    h = torch.where(maxc == rr, (gg - bb) / safe,
                    torch.where(maxc == gg, 2.0 + (bb - rr) / safe, 4.0 + (rr - gg) / safe))
    h = torch.remainder(h / 6.0, 1.0)
    s = torch.clamp(s * (1.0 + r(3, aug["saturation"])[..., 0]), 0, 1)
    h = torch.remainder(h + r(4, aug["hue"])[..., 0], 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)[..., None]
    cases = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    rgb = torch.zeros_like(x)
    for k in range(5, -1, -1):
        rgb = torch.where(i == k, torch.stack(cases[k], -1), rgb)
    return torch.where(do, rgb.reshape(B, H, W, C) * 255.0, images)


def targets(xy, vis, H, W, sigma):
    ys = torch.arange(H, dtype=torch.float32, device=xy.device)
    xs = torch.arange(W, dtype=torch.float32, device=xy.device)
    c = xy.reshape(-1, 2)
    hm = torch.exp(-((ys[None, :] - c[:, 1:2]) ** 2)[:, :, None] / (2 * sigma ** 2)
                   - ((xs[None, :] - c[:, 0:1]) ** 2)[:, None, :] / (2 * sigma ** 2))
    hm = hm * (vis.reshape(-1, 1, 1) > 0)
    return hm.reshape(*xy.shape[:-1], H, W)


BN_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9): running = 0.9 running + 0.1 batch


def weighted_mse(pred, target):
    return (torch.where(target > 0.1, 100.0, 1.0) * (pred - target) ** 2).mean()


@torch.no_grad()
def update(params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
           ema: List[torch.Tensor], opt: Dict) -> None:
    """clip_by_global_norm, Adam (eps outside the square root), then the EMA; in place."""
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    if norm >= opt["clip_norm"]:
        grads = [g / norm * opt["clip_norm"] for g in grads]
    state["count"] += 1
    b1, b2, eps = opt["adam_b1"], opt["adam_b2"], opt["adam_eps"]
    c1, c2 = 1 - b1 ** state["count"], 1 - b2 ** state["count"]
    for p, g, mu, nu, e in zip(params, grads, state["mu"], state["nu"], ema):
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        p.add_(-opt["lr"] * (mu / c1) / (torch.sqrt(nu / c2) + eps))
        e.mul_(opt["ema_decay"]).add_((1 - opt["ema_decay"]) * p)
