"""Heatmap peaks as the pipeline defines them: the argmax, a 3x3 window around it (zero
outside the map), a Gaussian (x0, y0, sigma_x, sigma_y; amplitude 1) fitted by 20 steps of
projected Levenberg-Marquardt, the window centre where the fit does not improve on its
start, scaled to the image by pixel centres; visible where the maximum exceeds the
threshold. Also where a peak lies on a heatmap's grid, for judging the port's peaks."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gauss(p, gx, gy):
    x0, y0, sx, sy = (p[:, i:i + 1] for i in range(4))
    dx, dy = gx - x0, gy - y0
    g = torch.exp(-(dx ** 2 / (2 * sx ** 2) + dy ** 2 / (2 * sy ** 2)))
    J = torch.stack([g * dx / sx ** 2, g * dy / sy ** 2, g * dx ** 2 / sx ** 3,
                     g * dy ** 2 / sy ** 3], -1)
    return g, J


def _fit(w):
    B, dev = w.shape[0], w.device
    gy, gx = torch.meshgrid(torch.arange(3., device=dev), torch.arange(3., device=dev),
                            indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    p0 = torch.cat([torch.ones(B, 2, device=dev), torch.ones(B, 2, device=dev)], 1)
    p, lam, eye = p0, torch.full((B,), 1e-2, device=dev), torch.eye(4, device=dev)
    for _ in range(20):
        g, J = _gauss(p, gx, gy)
        r = g - w
        A = J.transpose(1, 2) @ J + lam[:, None, None] * eye
        grad = (J.transpose(1, 2) @ r[..., None])[..., 0]
        pn = p - torch.linalg.solve_ex(A, grad)[0]
        pn = torch.cat([pn[:, :2].clamp(0.0, 3.0), pn[:, 2:].clamp(0.5, 50.0)], 1)
        better = ((_gauss(pn, gx, gy)[0] - w) ** 2).mean(-1) < (r ** 2).mean(-1)
        p = torch.where(better[:, None], pn, p)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-6, 1e6)
    ok = ((_gauss(p, gx, gy)[0] - w) ** 2).mean(-1) < ((_gauss(p0, gx, gy)[0] - w) ** 2).mean(-1) \
        + 1e-9
    return torch.where(ok, p[:, 0], 1.0), torch.where(ok, p[:, 1], 1.0)


def extract(heat: torch.Tensor, img_w: int, img_h: int, threshold: float) -> torch.Tensor:
    """heat (..., H, W) -> (..., 3): x, y in image pixels and visibility."""
    *batch, H, W = heat.shape
    flat = heat.reshape(-1, H, W).float()
    B = flat.shape[0]
    idx = flat.reshape(B, -1).argmax(1)
    ym, xm = idx // W, idx % W
    act = flat.reshape(B, -1).gather(1, idx[:, None])[:, 0]
    pad = F.pad(flat, (1, 1, 1, 1))
    off = torch.arange(3, device=flat.device)
    win = pad[torch.arange(B, device=flat.device)[:, None, None], (ym[:, None] + off)[:, :, None],
              (xm[:, None] + off)[:, None, :]]
    xo, yo = _fit(win.reshape(B, 9))
    x = (xm.float() - 1 + xo + 0.5) * (img_w / W) - 0.5
    y = (ym.float() - 1 + yo + 0.5) * (img_h / H) - 0.5
    return torch.stack([x, y, (act > threshold).float()], -1).reshape(*batch, 3)


def grid_window(xy: torch.Tensor, img_w: int, img_h: int, H: int, W: int):
    """The heatmap cells that could hold the argmax behind a peak at image point xy (..., 2):
    the fit moves a peak at most one cell below and two above its argmax, so the argmax lies
    in [u - 2, u + 1] on each axis, u the peak on the grid. -> (x_lo, x_hi, y_lo, y_hi)
    inclusive, clamped to the map."""
    u = (xy[..., 0] + 0.5) * (W / img_w) - 0.5
    v = (xy[..., 1] + 0.5) * (H / img_h) - 0.5
    x_lo = torch.ceil(u - 2 - 1e-4).clamp(0, W - 1).long()
    x_hi = torch.floor(u + 1 + 1e-4).clamp(0, W - 1).long()
    y_lo = torch.ceil(v - 2 - 1e-4).clamp(0, H - 1).long()
    y_hi = torch.floor(v + 1 + 1e-4).clamp(0, H - 1).long()
    return x_lo, x_hi, y_lo, y_hi
