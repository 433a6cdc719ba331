"""Camera calibration from the 13 table keypoints: normalised DLT, RQ, LM refinement,
RANSAC and a basin-hopping polish, batched in torch.

Port of `upliftingtabletennis_tpu/core/calibration.py`. Where the JAX module maps a
function over hypotheses or starts with `vmap`, the functions here take leading batch
dimensions: `refine_camera` refines any batch of starting cameras at once, each with its
own keypoint weights.

* The camera has 8 parameters (fx, fy, tx, ty, tz, Euler xyz); the principal point is
  fixed at (W // 2, H // 2) of the frame.
* LM runs a fixed number of iterations (`LM_ITERS`), as the JAX `lax.scan`; objective
  'l1' reweights the residuals (IRLS) to minimise the sum of distances.
* The Jacobian of the residuals is analytic (`_residual_jacobian`; the JAX module takes
  `jax.jacfwd`): a few dozen batched launches per LM step on the card, not a traced
  forward-mode pass.
* f32 throughout, matmuls included: the port leaves PyTorch's default of no TF32 alone,
  as the uplifting model does (the JAX module uses `Precision.HIGHEST`); solves and
  factorisations are f32 LAPACK or cuSOLVER calls.
* The random draws are explicit inputs: `ransac_u` (RANSAC_ITERS, 13) uniforms in [0, 1)
  pick each hypothesis' sampled keypoints, and `polish_normal` (POLISH_ROUNDS,
  POLISH_RESTARTS, 8) standard normals jitter the polish's restarts. JAX draws them from
  `jax.random` (PRNGKey(42) by default), which torch cannot reproduce, so a test passes
  JAX's draws to both; by default the port draws them from a seeded `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from upliftingtabletennis_torch.core.geometry import (BASE_FX, BASE_FY, TABLE_HEIGHT,
                                                      TABLE_POINTS, get_Mext, world2img)

__all__ = ["euler_xyz_to_matrix", "matrix_to_euler_xyz", "dlt", "rq3",
           "decompose_projection_matrix", "dlt_calib", "refine_camera", "canonical_starts",
           "refine_camera_multistart", "draw_calibration_noise", "calibrate_camera",
           "calibrate_from_keypoints"]

RANSAC_ITERS = 100
RANSAC_POINTS = 6
RANSAC_FIXED = (9, 10)  # the net-top keypoints, the only ones off the table's plane
INLIER_THRESHOLD = 3.5
LM_ITERS = 40
POLISH_RESTARTS = 32
POLISH_ROUNDS = 2
POLISH_ITERS = 60
DEFAULT_SEED = 42


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b for a batch of small systems; `solve_ex` checks no error, so no sync."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """angles (..., 3) = (a, b, c) -> R = Rz(c) Ry(b) Rx(a) (scipy's extrinsic 'xyz')."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa, cb, sb, cc, sc = (torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b),
                              torch.cos(c), torch.sin(c))
    return torch.stack([
        torch.stack([cc * cb, -sc * ca + cc * sb * sa, sc * sa + cc * sb * ca], -1),
        torch.stack([sc * cb, cc * ca + sc * sb * sa, -cc * sa + sc * sb * ca], -1),
        torch.stack([-sb, cb * sa, cb * ca], -1),
    ], -2)


def matrix_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """The inverse of euler_xyz_to_matrix (asin of a clamped entry)."""
    b = -torch.arcsin(R[..., 2, 0].clamp(-1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([a, b, c], -1)


def _normalize(points: torch.Tensor, w: torch.Tensor):
    """Weighted zero-mean, unit-std points (..., N, d) and their (d+1, d+1) transform."""
    wsum = w.sum(-1).clamp_min(1e-9)[..., None]
    mean = (points * w[..., None]).sum(-2) / wsum
    std = ((((points - mean[..., None, :]) ** 2) * w[..., None]).sum(-2) / wsum).sqrt()
    std = torch.where(std < 1e-10, torch.full_like(std, 1e-10), std)
    d = points.shape[-1]
    T = torch.zeros((*std.shape[:-1], d + 1, d + 1), dtype=points.dtype, device=points.device)
    idx = torch.arange(d, device=points.device)
    T[..., idx, idx] = 1.0 / std
    T[..., :d, d] = -mean / std
    T[..., d, d] = 1.0
    return (points - mean[..., None, :]) / std[..., None, :], T


def dlt(points_3d: torch.Tensor, points_2d: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projection matrix P (..., 3, 4) from (..., N, 3) / (..., N, 2) correspondences by
    normalised DLT; rows of weight 0 are left out (zero rows of the design matrix)."""
    w = torch.ones_like(points_3d[..., 0]) if weights is None else weights
    p3n, T3 = _normalize(points_3d, w)
    p2n, T2 = _normalize(points_2d, w)
    X, Y, Z = p3n[..., 0], p3n[..., 1], p3n[..., 2]
    x, y = p2n[..., 0], p2n[..., 1]
    zero, one = torch.zeros_like(X), torch.ones_like(X)
    row_x = torch.stack([-X, -Y, -Z, -one, zero, zero, zero, zero, x * X, x * Y, x * Z, x], -1)
    row_y = torch.stack([zero, zero, zero, zero, -X, -Y, -Z, -one, y * X, y * Y, y * Z, y], -1)
    A = torch.cat([row_x * w[..., None], row_y * w[..., None]], dim=-2)  # (..., 2N, 12)
    Vt = torch.linalg.svd(A, full_matrices=True)[2]
    P_norm = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 4)
    P = torch.linalg.inv_ex(T2)[0] @ P_norm @ T3
    # P[2, 3] = 1, or a unit Frobenius norm where P[2, 3] is 0 (the SVD's sign is free)
    p23 = P[..., 2, 3, None, None]
    return torch.where(p23.abs() > 1e-12, P / p23,
                       P / torch.linalg.norm(P, dim=(-2, -1), keepdim=True))


def rq3(M: torch.Tensor):
    """RQ of (..., 3, 3) by QR of the reversed matrix: M = K Q, K upper triangular. The
    reversal permutation is a flip of rows or columns."""
    Q, R = torch.linalg.qr(M.flip(-2).mT)
    return R.mT.flip(-2).flip(-1), Q.mT.flip(-2)


def _det3(R: torch.Tensor) -> torch.Tensor:
    return (R[..., 0, 0] * (R[..., 1, 1] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 1])
            - R[..., 0, 1] * (R[..., 1, 0] * R[..., 2, 2] - R[..., 1, 2] * R[..., 2, 0])
            + R[..., 0, 2] * (R[..., 1, 0] * R[..., 2, 1] - R[..., 1, 1] * R[..., 2, 0]))


def decompose_projection_matrix(P: torch.Tensor):
    """P (..., 3, 4) -> (K (..., 3, 3), R (..., 3, 3), t (..., 3)): K's diagonal made
    positive, K[2, 2] = 1, and R's third column flipped where det R < 0."""
    K, R = rq3(P[..., :3])
    signs = torch.sign(torch.diagonal(K, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    K = K * signs[..., None, :]
    R = R * signs[..., :, None]
    K = K / K[..., 2:3, 2:3]
    flip = torch.where(_det3(R) < 0, -1.0, 1.0).to(R.dtype)
    R = torch.cat([R[..., :2], R[..., 2:] * flip[..., None, None]], dim=-1)
    return K, R, _solve(K, P[..., 3])


def _extrinsics(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]), torch.ones_like(top[..., :1, :1])],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def dlt_calib(points_3d, points_2d, weights=None):
    """(Mint (..., 3, 3), Mext (..., 4, 4)) by DLT and decomposition."""
    K, R, t = decompose_projection_matrix(dlt(points_3d, points_2d, weights))
    return K, _extrinsics(R, t)


def _params_to_cams(x: torch.Tensor, resolution):
    """x (..., 8) -> (Mint (..., 3, 3), Mext (..., 4, 4))."""
    W, H = resolution
    zero, one = torch.zeros_like(x[..., 0]), torch.ones_like(x[..., 0])
    Mint = torch.stack([torch.stack([x[..., 0], zero, zero + (W // 2)], -1),
                        torch.stack([zero, x[..., 1], zero + (H // 2)], -1),
                        torch.stack([zero, zero, one], -1)], -2)
    return Mint, _extrinsics(euler_xyz_to_matrix(x[..., 5:8]), x[..., 2:5])


def _residual_dists(x, points_3d, points_2d, resolution):
    """Reprojection distances (..., N) of the cameras x (..., 8)."""
    Mint, Mext = _params_to_cams(x, resolution)
    p3 = points_3d.expand(*x.shape[:-1], *points_3d.shape[-2:])
    proj = world2img(p3, Mext, Mint)
    return (((proj - points_2d) ** 2).sum(-1) + 1e-12).sqrt()


def _cams_to_params(Mint, Mext):
    angles = matrix_to_euler_xyz(Mext[..., :3, :3])
    angles = torch.remainder(angles + math.pi, 2 * math.pi) - math.pi
    return torch.cat([torch.stack([Mint[..., 0, 0], Mint[..., 1, 1], Mext[..., 0, 3],
                                   Mext[..., 1, 3], Mext[..., 2, 3]], -1), angles], -1)


def _axis_rotations(angles: torch.Tensor):
    """(Rx(a), Ry(b), Rz(c)) and their derivatives, each (..., 3, 3)."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa, cb, sb, cc, sc = (torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b),
                              torch.cos(c), torch.sin(c))
    o, z = torch.ones_like(a), torch.zeros_like(a)

    def m(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    return (m((o, z, z), (z, ca, -sa), (z, sa, ca)), m((cb, z, sb), (z, o, z), (-sb, z, cb)),
            m((cc, -sc, z), (sc, cc, z), (z, z, o)),
            m((z, z, z), (z, -sa, -ca), (z, ca, -sa)), m((-sb, z, cb), (z, z, z), (-cb, z, -sb)),
            m((-sc, -cc, z), (cc, -sc, z), (z, z, z)))


def _residual_jacobian(x, points_3d, points_2d, resolution):
    """d residual / d x (..., N, 8) of `_residual_dists`, analytic: with the camera point
    (X, Y, Z) = R p + t and the error e = proj - p2, d = |e| and
    d d / d theta = e . d proj / d theta / d, where proj = (fx X / Z + W // 2, fy Y / Z +
    H // 2) and d R / d angle = Rz Ry Rx' , Rz Ry' Rx, Rz' Ry Rx."""
    W, H = resolution
    Rx, Ry, Rz, dRx, dRy, dRz = _axis_rotations(x[..., 5:8])
    R = euler_xyz_to_matrix(x[..., 5:8])
    dR = torch.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx], dim=-3)  # (..., 3 angles, 3, 3)
    cam = (R[..., None, :, :] @ points_3d[..., None])[..., 0] + x[..., None, 2:5]  # (..., N, 3)
    Xc, Yc, Zc = cam[..., 0], cam[..., 1], cam[..., 2]
    fx, fy = x[..., 0:1], x[..., 1:2]
    e = torch.stack([fx * Xc / Zc + W // 2, fy * Yc / Zc + H // 2], -1) - points_2d
    d = ((e ** 2).sum(-1) + 1e-12).sqrt()
    # d cam / d (tx, ty, tz, a, b, c): (..., N, 3 coords, 6)
    dcam_t = torch.eye(3, dtype=x.dtype, device=x.device).expand(*cam.shape, 3)
    dcam_ang = (dR[..., None, :, :, :] @ points_3d[..., None, :, None])[..., 0].movedim(-2, -1)
    dcam = torch.cat([dcam_t, dcam_ang], dim=-1)
    dpx = (fx / Zc)[..., None] * dcam[..., 0, :] - (fx * Xc / Zc ** 2)[..., None] * dcam[..., 2, :]
    dpy = (fy / Zc)[..., None] * dcam[..., 1, :] - (fy * Yc / Zc ** 2)[..., None] * dcam[..., 2, :]
    J = torch.cat([(e[..., 0] * Xc / Zc)[..., None], (e[..., 1] * Yc / Zc)[..., None],
                   e[..., 0:1] * dpx + e[..., 1:2] * dpy], dim=-1)
    return J / d[..., None]


def refine_camera(points_3d, points_2d, weights, resolution, start, objective: str = "l1",
                  iters: int = LM_ITERS):
    """LM refinement of the 8-parameter camera from start = (Mint (..., 3, 3), Mext (...,
    4, 4)), weights (..., N) per start. 'l1' reweights the residuals (IRLS) for the sum of
    distances; 'l2' is plain LM on the distances. Returns (Mint, Mext, the weighted mean
    residual), each with the start's batch dimensions."""
    x = _cams_to_params(*start)
    weights = weights.expand(*x.shape[:-1], weights.shape[-1])

    def residuals(v):
        return _residual_dists(v, points_3d, points_2d, resolution)

    eye = torch.eye(8, dtype=x.dtype, device=x.device)
    lam = torch.full(x.shape[:-1], 1e-2, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r = residuals(x)
        w = weights / r.clamp_min(1e-3).sqrt() if objective == "l1" else weights
        Jw = _residual_jacobian(x, points_3d, points_2d, resolution) * w[..., None]
        A = Jw.mT @ Jw + lam[..., None, None] * eye
        g = (Jw.mT @ (r * w)[..., None])[..., 0]
        x_new = x - _solve(A, g)
        accept = (weights * residuals(x_new)).sum(-1) < (weights * r).sum(-1)
        x = torch.where(accept[..., None], x_new, x)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e8)
    Mint, Mext = _params_to_cams(x, resolution)
    mean_res = (weights * residuals(x)).sum(-1) / weights.sum(-1).clamp_min(1e-9)
    return Mint, Mext, mean_res


def canonical_starts(dtype=torch.float32, device="cpu"):
    """Broadcast-camera poses used as extra starts (10 m away, 40 degrees up, three
    azimuths, the regressed broadcast focal lengths): [(Mint, Mext)] x 3."""
    outs = []
    for phi_deg in (40.0, 90.0, 140.0):
        phi, theta = np.deg2rad(phi_deg), np.deg2rad(50.0)
        c = np.array([10 * np.sin(theta) * np.cos(phi), 10 * np.sin(theta) * np.sin(phi),
                      10 * np.cos(theta) + TABLE_HEIGHT])
        f = np.array([0.0, 0.0, TABLE_HEIGHT]) - c
        f = f / np.linalg.norm(f)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r = r / np.linalg.norm(r)
        Mext = get_Mext(*(torch.as_tensor(v, dtype=dtype, device=device) for v in (c, f, r)))
        Mint = torch.tensor([[BASE_FX, 0, 0], [0, BASE_FY, 0], [0, 0, 1.0]], dtype=dtype,
                            device=device)
        outs.append((Mint, Mext))
    return outs


def refine_camera_multistart(points_3d, points_2d, weights, resolution, dlt_start,
                             objective="l1", iters=LM_ITERS):
    """LM from the DLT start (..., 3, 3) / (..., 4, 4) and the three canonical starts;
    the start with the lowest mean residual wins, per batch element."""
    Mint0, Mext0 = dlt_start
    batch = weights.shape[:-1]
    canon = canonical_starts(points_2d.dtype, points_2d.device)
    Mints = torch.stack([Mint0.expand(*batch, 3, 3)]
                        + [m.expand(*batch, 3, 3) for m, _ in canon], dim=-3)
    Mexts = torch.stack([Mext0.expand(*batch, 4, 4)]
                        + [e.expand(*batch, 4, 4) for _, e in canon], dim=-3)
    Mi, Me, res = refine_camera(points_3d, points_2d, weights[..., None, :], resolution,
                                (Mints, Mexts), objective, iters)
    best = res.argmin(-1)

    def pick(t):
        idx = best.reshape(*best.shape, 1, *([1] * (t.ndim - best.ndim - 1)))
        return t.gather(best.ndim, idx.expand(*best.shape, 1, *t.shape[best.ndim + 1:])
                        ).squeeze(best.ndim)

    return pick(Mi), pick(Me), pick(res)


def _sample_hypothesis_weights(u: torch.Tensor, visibility: torch.Tensor) -> torch.Tensor:
    """Keypoint weights (..., N) of hypotheses: the fixed net-top points and the visible
    others of the 4 lowest draws u (..., N)."""
    fixed = torch.zeros_like(visibility)
    fixed[list(RANSAC_FIXED)] = 1.0
    candidates = visibility * (1.0 - fixed)
    priority = torch.where(candidates > 0, u, torch.full_like(u, 2.0))
    order = torch.argsort(priority, dim=-1, stable=True)
    chosen = torch.zeros_like(u).scatter(-1, order[..., :RANSAC_POINTS - len(RANSAC_FIXED)], 1.0)
    return (chosen * candidates + fixed * visibility).clamp(0.0, 1.0)


def draw_calibration_noise(generator: Optional[torch.Generator] = None,
                           dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ransac_u (RANSAC_ITERS, 13) uniforms, polish_normal (POLISH_ROUNDS,
    POLISH_RESTARTS, 8) standard normals) on the CPU, from `generator` (a
    torch.Generator seeded with DEFAULT_SEED when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(DEFAULT_SEED)
    u = torch.rand(RANSAC_ITERS, len(TABLE_POINTS), generator=generator, dtype=dtype)
    j = torch.randn(POLISH_ROUNDS, POLISH_RESTARTS, 8, generator=generator, dtype=dtype)
    return u, j


def _basin_hop_polish(points_3d, points_2d, visibility, resolution, Mint, Mext, polish_normal):
    """L2 polish: LM from the camera and from POLISH_RESTARTS jittered copies of the best
    (3% focal, 15 cm translation, 0.01 rad angles) for POLISH_ROUNDS rounds, on the points
    within 2x INLIER_THRESHOLD; kept when at least 6 points are that close."""
    err = torch.linalg.norm(world2img(points_3d, Mext, Mint) - points_2d, dim=-1)
    w = ((err < 2.0 * INLIER_THRESHOLD) & (visibility > 0)).to(points_2d.dtype)
    enough = w.sum() >= 6.0

    def refit_from(x):
        return refine_camera(points_3d, points_2d, w, resolution,
                             _params_to_cams(x, resolution), "l2", POLISH_ITERS)

    best_Mi, best_Me, best_res = refit_from(_cams_to_params(Mint, Mext))
    bx = _cams_to_params(best_Mi, best_Me)
    for j in polish_normal:
        x = torch.cat([bx[:2] * (1.0 + j[:, :2] * 0.03), bx[2:5] + j[:, 2:5] * 0.15,
                       bx[5:8] + j[:, 5:8] * 0.01], dim=-1)
        Mis, Mes, res = refit_from(x)
        bi = res.argmin()
        better = res[bi] < best_res
        best_Mi = torch.where(better, Mis[bi], best_Mi)
        best_Me = torch.where(better, Mes[bi], best_Me)
        best_res = torch.minimum(res[bi], best_res)
        bx = _cams_to_params(best_Mi, best_Me)
    return torch.where(enough, best_Mi, Mint), torch.where(enough, best_Me, Mext)


def calibrate_camera(points_2d: torch.Tensor, visibility: torch.Tensor, resolution,
                     use_ransac: bool = False, objective: str = "l1",
                     ransac_u: Optional[torch.Tensor] = None,
                     polish_normal: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Keypoints (13, 2) in pixels and visibility (13,) {0, 1} -> (Mint (3, 3), Mext
    (4, 4), inlier count), on points_2d's device. DLT start, then multistart LM; with
    RANSAC, RANSAC_ITERS hypotheses (the net-top points plus 4 sampled visible ones), the
    refit on the best one's inliers and the basin-hopping polish. The caller ensures at
    least 6 visible points. Draws not given come from `draw_calibration_noise(generator)`."""
    dev, dtype = points_2d.device, points_2d.dtype
    points_3d = torch.as_tensor(TABLE_POINTS, dtype=dtype, device=dev)
    vis = visibility.to(dtype)
    Mint0, Mext0 = dlt_calib(points_3d, points_2d, vis)
    if not use_ransac:
        Mint, Mext, _ = refine_camera_multistart(points_3d, points_2d, vis, resolution,
                                                 (Mint0, Mext0), objective)
        return Mint, Mext, visibility.sum().to(torch.int32)
    if ransac_u is None or polish_normal is None:
        u, j = draw_calibration_noise(generator, dtype)
        ransac_u = u if ransac_u is None else ransac_u
        polish_normal = j if polish_normal is None else polish_normal
    ransac_u, polish_normal = ransac_u.to(dev, dtype), polish_normal.to(dev, dtype)

    w = _sample_hypothesis_weights(ransac_u, vis)  # (RANSAC_ITERS, 13)
    Mints, Mexts, _ = refine_camera_multistart(points_3d, points_2d, w, resolution,
                                               (Mint0, Mext0), objective)
    err = torch.linalg.norm(world2img(points_3d.expand(len(w), -1, -1), Mexts, Mints)
                            - points_2d, dim=-1)
    inliers = (err < INLIER_THRESHOLD) & (visibility > 0)
    n_in = inliers.sum(1)
    best = n_in.argmax()
    Mint, Mext, _ = refine_camera(points_3d, points_2d, inliers[best].to(dtype), resolution,
                                  (Mints[best], Mexts[best]), objective)
    Mint, Mext = _basin_hop_polish(points_3d, points_2d, visibility, resolution, Mint, Mext,
                                   polish_normal)
    return Mint, Mext, n_in[best].to(torch.int32)


def calibrate_from_keypoints(keypoints: torch.Tensor, resolution, use_ransac: bool = True,
                             **draws):
    """keypoints (13, 3) = (x, y, visibility) -> (Mint, Mext, inlier count)."""
    return calibrate_camera(keypoints[:, :2], keypoints[:, 2], tuple(resolution), use_ransac,
                            **draws)
