"""Differentiable-physics trajectory and spin fitting from 2D detections.

Port of `upliftingtabletennis_tpu/core/fitting.py`. The initial conditions (r0, v0, w0)
of a rally segment are fitted to its observed 2D ball positions through the camera:

    minimize_{r0,v0,w0}  mean_t || project(simulate(r0, v0, w0)(t)) - obs_t ||^2

as a multi-start search: all starts integrate, project and take Adam steps together on a
coarse-to-fine time curriculum, then a damped Gauss-Newton (Levenberg-Marquardt) polish
sharpens every start, and a seed-aware rule picks the winner. The JAX module runs this
as one jitted program; here every simulate of a step is one launch of the S1 kernel for
all starts (`ops/physics.py`, tangent mode for the Adam gradient and the LM Jacobian,
forward mode for the LM's trial losses), and the rest is plain PyTorch. On CPU tensors
the plain versions run, in the input's dtype.

Adam is optax's `adam(cosine_decay_schedule(lr, adam_steps, alpha=0.05))` written out
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction). The starts' draws come from
an explicit `torch.Generator` (`draw_inits`), and `inits_from_draws` turns them into
starts as the JAX `default_inits` turns its own draws, so a test can feed it JAX's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.core import geometry as G
from upliftingtabletennis_torch.core.physics import DT, FPS, BallState
from upliftingtabletennis_torch.ops import physics as S1

__all__ = ["V_SCALE", "W_SCALE", "MAX_SPEED", "MAX_SPIN", "FitResult", "BallState",
           "positions_at_times", "draw_inits", "inits_from_draws", "default_inits",
           "fit_trajectory", "fit_trajectory_batch", "spin_class_from_fit"]

# Scales that bring r0 (m), v0 (m/s), w0 (rad/s) to O(1) optimisation variables.
V_SCALE = 10.0
W_SCALE = 100.0
# Soft plausibility bounds: the datagen priors sample speeds 3-30 m/s, spins 0-500 rad/s.
MAX_SPEED = 35.0
MAX_SPIN = 600.0
SUBSTEPS = int(round(1.0 / (FPS * DT)))
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LR_ALPHA = 0.05  # the cosine schedule's floor, as a fraction of lr


class FitResult(NamedTuple):
    state0: BallState  # the winning start's initial conditions, (..., 3) tensors
    r_world: torch.Tensor  # (..., T, 3) fitted 3D positions at the observation times
    loss: torch.Tensor  # the winner's final loss (mean px^2 + penalty)
    all_loss: torch.Tensor  # (..., n_starts) final losses of every start
    best: torch.Tensor  # index of the winning start
    # masked mean px distance between the winner's reprojection and the observed track:
    # the fit's convergence gate, computable without ground truth
    reproj_px: torch.Tensor
    # the largest distance (m) between the winner's initial position and that of any
    # start whose final loss is within the tie band (1.3x + 0.5): large when several
    # basins explain the 2D track equally well (depth not identifiable)
    basin_spread_m: torch.Tensor


def _params_to_state(q: torch.Tensor) -> BallState:
    """(..., 9) scaled optimisation vector -> BallState of (..., 3) tensors."""
    return S1.params_to_state(q, V_SCALE, W_SCALE)


def _state_to_params(state: BallState) -> torch.Tensor:
    return torch.cat([state.r, state.v / V_SCALE, state.w / W_SCALE], -1)


def _interp(frames: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of frames (F, B, S, ...) on the FPS grid (frame k at k / FPS)
    onto per-track times (B, T) seconds: (B, T, S, ...)."""
    B, T = times.shape
    idx = times * FPS
    i0 = torch.clamp(torch.floor(idx).long(), 0, frames.shape[0] - 2)
    frac = torch.clamp(idx - i0.to(idx.dtype), 0.0, 1.0)
    frac = frac.reshape(B, T, *([1] * (frames.ndim - 2)))
    b = torch.arange(B, device=frames.device)[:, None]
    return frames[i0, b] * (1.0 - frac) + frames[i0 + 1, b] * frac


def positions_at_times(traj_r: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of traj_r (F, ..., 3) on the FPS grid onto times (T,) seconds:
    (T, ..., 3)."""
    return _interp(traj_r[:, None], times[None])[0]


def _positions(q: torch.Tensor, n_frames: int, substeps: int, dt: float) -> torch.Tensor:
    """Frames (F, ..., 3) of the starts q (..., 9): through the tangent mode where
    autograd records q, else the forward mode."""
    if torch.is_grad_enabled() and q.requires_grad:
        return S1.trajectory_positions(q, n_frames, substeps, dt, V_SCALE, W_SCALE)
    return S1.simulate(_params_to_state(q), n_frames, substeps, dt).r


def _batched_loss_terms(q, obs, times, mask, Mint, Mext, n_frames, substeps, dt, huber_px):
    """Per-start (masked mean px^2 data term, soft plausibility penalty), (B, S) each:
    q (B, S, 9); obs (B, T, 2); times, mask (B, T); Mint (B, 3, 3); Mext (B, 4, 4)."""
    state0 = _params_to_state(q)
    r_bt = _interp(_positions(q, n_frames, substeps, dt), times)
    proj = G.world2img(r_bt, Mext, Mint)  # (B, T, S, 2) through each track's camera
    d2 = ((proj - obs[:, :, None, :]) ** 2).sum(-1)  # (B, T, S)
    if huber_px is not None:
        # Huber on the px distance: quadratic core, linear tail
        d = torch.sqrt(d2 + 1e-12)
        d2 = torch.where(d < huber_px, d2, huber_px * (2.0 * d - huber_px))
    data = (d2 * mask[:, :, None]).sum(1) / torch.clamp_min(mask.sum(1), 1.0)[:, None]
    speed = torch.linalg.norm(state0.v, dim=-1)
    spin = torch.linalg.norm(state0.w, dim=-1)
    penalty = (torch.clamp_min(speed - MAX_SPEED, 0.0) ** 2
               + torch.clamp_min((spin - MAX_SPIN) / W_SCALE, 0.0) ** 2
               + torch.clamp_min(-state0.r[..., 2], 0.0) ** 2) * 100.0
    return data, penalty


def _loss_terms(q, obs, times, mask, Mint, Mext, n_frames, substeps, dt, huber_px):
    """Per-start (data term, penalty) of q (S, 9) on one track: obs (T, 2), mask (T,).
    Returns ((S,), (S,)); differentiable in q."""
    data, pen = _batched_loss_terms(q[None], obs[None], times[None], mask[None], Mint[None],
                                    Mext[None], n_frames, substeps, dt, huber_px)
    return data[0], pen[0]


# --- the starts: draws, then a deterministic function of them ---------------------------
def draw_inits(n_starts: int, generator: Optional[torch.Generator] = None,
               device="cuda", dtype=torch.float32) -> dict:
    """The random draws of `inits_from_draws` for n_starts starts on `device`, from
    `generator`: flight heights z_t (S,) in [0.85, 1.9), speed factors v_mult (S, 1) in
    [0.7, 1.3), velocity noise v_noise (S, 3) and spin noise w_noise (S, 3), standard
    normal."""
    device = resolve_device(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return torch.clamp_min(u * (hi - lo) + lo, lo)

    z_t = uniform((n_starts,), 0.85, 1.9)
    v_noise = torch.randn((n_starts, 3), generator=generator, device=device, dtype=dtype)
    w_noise = torch.randn((n_starts, 3), generator=generator, device=device, dtype=dtype)
    v_mult = uniform((n_starts, 1), 0.7, 1.3)
    return {"z_t": z_t, "v_mult": v_mult, "v_noise": v_noise, "w_noise": w_noise}


def inits_from_draws(draws: dict, obs, times, mask, Mint, Mext) -> BallState:
    """Observation-driven starts, (S, 3) tensors: the first visible detection
    back-projected onto its camera ray at the drawn flight heights, the velocity from a
    second detection about 6 frames later at matched forward depth (with the drawn
    factor and noise, capped at 32 m/s), and the spin from the drawn noise."""
    T = obs.shape[0]
    vis = mask > 0
    i0 = torch.argmax(vis.to(torch.int8))
    ar = torch.arange(T, device=obs.device)
    later6 = (ar >= i0 + 5) & vis
    later1 = (ar > i0) & vis
    i1 = torch.where(later6.any(), torch.argmax(later6.to(torch.int8)),
                     torch.argmax(later1.to(torch.int8)))

    K = Mint[:3, :3]
    R = Mext[:3, :3]
    c = G.get_camera_location(Mext)
    fwd = G.get_forward(Mext)
    Kinv = torch.linalg.inv(K)

    def ray(uv):
        d = R.T @ (Kinv @ torch.cat([uv, torch.ones_like(uv[:1])]))
        return d / torch.linalg.norm(d)

    d0, d1 = ray(obs[i0]), ray(obs[i1])
    z_t = draws["z_t"]
    s0 = torch.clamp((z_t - c[2]) / torch.where(torch.abs(d0[2]) < 1e-3,
                                               torch.full_like(d0[2], 1e-3), d0[2]), 1.5, 30.0)
    p0 = c + s0[:, None] * d0
    # the second point at matched forward depth -> velocity estimate
    s1 = s0 * torch.dot(d0, fwd) / torch.clamp_min(torch.dot(d1, fwd), 1e-3)
    p1 = c + s1[:, None] * d1
    dt_obs = torch.clamp_min(times[i1] - times[i0], 1e-3)
    # ballistic correction: p1 ~ p0 + v dt - g/2 dt^2 z  =>  v_z gets + g dt / 2
    g_half = torch.tensor([0.0, 0.0, 4.905], dtype=obs.dtype, device=obs.device)
    v_est = (p1 - p0) / dt_obs + g_half * dt_obs
    v = v_est * draws["v_mult"]
    v = v + 1.5 * draws["v_noise"]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v * torch.clamp_max(torch.full_like(vn, 32.0) / torch.clamp_min(vn, 1e-6), 1.0)
    w = 150.0 * draws["w_noise"]
    r0 = p0 - v * times[i0]  # extrapolate back to the t = 0 grid origin
    return BallState(r=r0, v=v, w=w)


def default_inits(obs, times, mask, Mint, Mext, n_starts: int,
                  generator: Optional[torch.Generator] = None) -> BallState:
    """`inits_from_draws` on draws from `generator` (on the inputs' device)."""
    draws = draw_inits(n_starts, generator, obs.device, obs.dtype)
    return inits_from_draws(draws, obs, times, mask, Mint, Mext)


# --- the fit ------------------------------------------------------------------------
def _lr(step: int, lr: float, steps: int) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha=LR_ALPHA) at `step`."""
    count = min(float(step), float(steps))
    cosine = 0.5 * (1 + math.cos(math.pi * count / steps))
    return lr * ((1 - LR_ALPHA) * cosine + LR_ALPHA)


def _residual_jacobian(r_frames, jac_frames, times, Mint, Mext):
    """LM's projected positions (B, T, S, 2) and their Jacobian (B, T, S, 2, 9) from the
    frames' positions (F, B, S, 3) and tangents (F, B, S, 3, 9): the tangents are
    interpolated as the positions are, then pushed through the pinhole projection
    (world -> camera -> pixels, each a quotient)."""
    r = _interp(r_frames, times)
    dr = _interp(jac_frames, times)
    Me = Mext[:, None, None]
    K = Mint[:, None, None, :3, :3]
    cam = (Me[..., :3] @ r[..., None])[..., 0] + Me[..., 3]  # (B, T, S, 4)
    dcam = Me[..., :3] @ dr  # (B, T, S, 4, 9)
    w = cam[..., 3:4, None]
    xc = cam[..., :3] / cam[..., 3:4]
    dxc = (dcam[..., :3, :] * w - cam[..., :3, None] * dcam[..., 3:4, :]) / (w * w)
    h = (K @ xc[..., None])[..., 0]
    dh = K @ dxc
    z = h[..., 2:3, None]
    dpix = (dh[..., :2, :] * z - h[..., :2, None] * dh[..., 2:3, :]) / (z * z)
    return G.world2img(r, Mext, Mint), dpix


def _run_fit_batched(q0, obs, times, mask, Mint, Mext, *, n_frames, substeps, dt,
                     adam_steps, lm_steps, lr, huber_px, seed_q=None, seed_rel=0.0):
    """The fit of B tracks at once: q0 (B, S, 9); obs (B, T, 2); times, mask (B, T);
    Mint (B, 3, 3); Mext (B, 4, 4); seed_q (B, 9) or None. Every physics call of a step
    runs all B * S starts together. Returns a FitResult of (B, ...) tensors."""
    B, S, _ = q0.shape
    T = obs.shape[1]
    loss_args = (obs, times, mask, Mint, Mext, n_frames, substeps, dt, huber_px)

    # --- phase 1: Adam on all starts (elementwise moments: an independent Adam per
    # start), with a coarse-to-fine time curriculum from ~25% of the visible track to
    # all of it over the first 60% of the steps
    vis = mask > 0
    t_max = torch.where(vis, times, torch.zeros_like(times)).amax(1)
    order = torch.sort(torch.where(vis, times, torch.full_like(times, math.inf)), dim=1).values
    n_vis = vis.sum(1)
    t_lo = order.gather(1, torch.clamp(n_vis // 4, 1, T - 1)[:, None])[:, 0]
    ramp_end = max(int(0.6 * adam_steps), 1)
    q = q0.clone()
    m1 = torch.zeros_like(q)
    m2 = torch.zeros_like(q)
    for i in range(adam_steps):
        frac = min(float(np.float32(i) / np.float32(ramp_end)), 1.0)
        t_cut = t_lo + (t_max - t_lo + 1e-3) * frac
        m = mask * (times <= t_cut[:, None])
        qv = q.detach().requires_grad_(True)
        data, pen = _batched_loss_terms(qv, obs, times, m, *loss_args[3:])
        (g,) = torch.autograd.grad((data + pen).sum(), qv)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m1 = (1 - ADAM_B1) * g + ADAM_B1 * m1
        m2 = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * m2
        m1_hat = m1 / (1 - ADAM_B1 ** (i + 1))
        m2_hat = m2 / (1 - ADAM_B2 ** (i + 1))
        q = q + -_lr(i, lr, max(adam_steps, 1)) * (m1_hat / (torch.sqrt(m2_hat) + ADAM_EPS))

    # --- phase 2: damped Gauss-Newton on every start at once
    def losses_of(qq):
        with torch.no_grad():
            data, pen = _batched_loss_terms(qq, *loss_args)
        return data + pen

    if lm_steps > 0:
        f_c = losses_of(q)
        lam = torch.full((B, S), 1e-2, dtype=q.dtype, device=q.device)
        eye = torch.eye(9, dtype=q.dtype, device=q.device)
        for _ in range(lm_steps):
            r_frames, jac = S1.simulate_tangent(_params_to_state(q), n_frames, substeps, dt,
                                                V_SCALE, W_SCALE)
            pix, dpix = _residual_jacobian(r_frames, jac, times, Mint, Mext)
            w = mask[:, :, None, None]
            res = ((pix - obs[:, :, None, :]) * w).permute(0, 2, 1, 3).reshape(B, S, 2 * T)
            J = (dpix * w[..., None]).permute(0, 2, 1, 3, 4).reshape(B, S, 2 * T, 9)
            JtJ = J.transpose(-1, -2) @ J
            grad = (J.transpose(-1, -2) @ res[..., None])[..., 0]
            A = JtJ + lam[..., None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1)) \
                + 1e-6 * eye
            dq = -torch.linalg.solve_ex(A, grad[..., None])[0][..., 0]
            q_n = q + dq
            f_n = losses_of(q_n)
            ok = torch.isfinite(f_n) & (f_n < f_c)
            q = torch.where(ok[..., None], q_n, q)
            f_c = torch.where(ok, f_n, f_c)
            lam = torch.where(ok, torch.clamp_min(lam * 0.3, 1e-8), torch.clamp_max(lam * 4.0, 1e6))
        losses = f_c
    else:
        losses = losses_of(q)

    finite = torch.where(torch.isfinite(losses), losses, torch.full_like(losses, math.inf))
    best = torch.argmin(finite, dim=1)
    ar = torch.arange(B, device=q.device)
    if seed_q is not None and seed_rel > 1.0:
        # among the starts within seed_rel of the minimum (plus a small absolute slack),
        # the one closest to the seed in scaled parameter space wins
        ok = finite <= finite[ar, best][:, None] * seed_rel + 0.5
        dist = torch.linalg.norm(q - seed_q[:, None, :], dim=-1)
        best = torch.argmin(torch.where(ok, dist, torch.full_like(dist, math.inf)), dim=1)
    q_best = q[ar, best]
    state0 = _params_to_state(q_best)
    with torch.no_grad():
        r_world = _interp(S1.simulate(_params_to_state(q_best[:, None]), n_frames, substeps,
                                      dt).r, times)[:, :, 0]
    proj = G.world2img(r_world, Mext, Mint)
    d = torch.linalg.norm(proj - obs, dim=-1)
    reproj_px = (d * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0)
    # depth identifiability: the 3D spread of the near-tied basins; the tie band anchors
    # at the global minimum (best may be the seed-arbitrated pick)
    tie = finite <= finite.amin(1, keepdim=True) * 1.3 + 0.5
    r0_d = torch.linalg.norm(q[..., :3] - q_best[:, None, :3], dim=-1)
    basin_spread = torch.where(tie, r0_d, torch.zeros_like(r0_d)).amax(1)
    return FitResult(state0=state0, r_world=r_world, loss=losses[ar, best], all_loss=losses,
                     best=best, reproj_px=reproj_px, basin_spread_m=basin_spread)


def _run_fit(q0, obs, times, mask, Mint, Mext, *, n_frames, substeps, dt, adam_steps,
             lm_steps, lr, huber_px, seed_q=None, seed_rel=0.0) -> FitResult:
    """Batched Adam search (coarse-to-fine horizon) + LM polish of one track: q0 (S, 9)
    scaled multi-start parameters -> FitResult of the winning start."""
    res = _run_fit_batched(
        q0[None], obs[None], times[None], mask[None], Mint[None, :3, :3], Mext[None],
        n_frames=n_frames, substeps=substeps, dt=dt, adam_steps=adam_steps,
        lm_steps=lm_steps, lr=lr, huber_px=huber_px,
        seed_q=None if seed_q is None else seed_q[None], seed_rel=seed_rel)
    return FitResult(BallState(*(x[0] for x in res.state0)), *(x[0] for x in res[1:]))


def _f32(x, dev):
    if not torch.is_tensor(x):
        x = torch.tensor(np.asarray(x, np.float32))
    return x.to(device=dev, dtype=torch.float32)


def fit_trajectory(obs, times, mask, Mint, Mext, *, generator: Optional[torch.Generator] = None,
                   n_starts: int = 32, adam_steps: int = 250, lm_steps: int = 12,
                   lr: float = 0.03, n_frames: Optional[int] = None, substeps: int = SUBSTEPS,
                   dt: float = DT, init_state: Optional[BallState] = None,
                   huber_px: Optional[float] = None, seed_select_rel: float = 1.3,
                   draws: Optional[dict] = None, device="cuda") -> FitResult:
    """Fit (r0, v0, w0) to observed 2D ball detections, in float32 on `device`.

    obs (T, 2) pixels; times (T,) seconds on the 500 fps grid's convention (frame k at
    k / FPS); mask (T,) 1 = valid; Mint (3, 3) or larger; Mext (4, 4). The horizon
    n_frames / 500 s must cover every visible time (the default does). `generator`
    draws the starts (seed 0 on `device` when None). `init_state` (tensors (3,) or
    (k, 3)) seeds extra starts, the uplifting model's prediction in the hybrid mode:
    the seeds replace the first k drawn starts and a spin-flipped copy of the first
    takes the next; the winner is then chosen among the starts within
    `seed_select_rel` of the minimum loss as the one closest to the seed.
    `huber_px` makes the data term a Huber px distance. `draws` (the dict of
    `draw_inits`) gives the starts' draws in place of `generator`'s."""
    dev = resolve_device(device)
    obs, times, mask, Mint, Mext = (_f32(a, dev) for a in (obs, times, mask, Mint, Mext))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if n_frames is None:
        t_max = float(torch.where(mask > 0, times, torch.zeros_like(times)).max())
        n_frames = max(int(t_max * FPS) + 2, 16)

    if draws is None:
        inits = default_inits(obs, times, mask, Mint, Mext, n_starts, generator)
    else:
        inits = inits_from_draws({k: _f32(v, dev) for k, v in draws.items()}, obs, times, mask,
                                 Mint, Mext)
    seed_q = None
    if init_state is not None:
        seed = BallState(*(torch.atleast_2d(_f32(a, dev)) for a in init_state))
        k = seed.r.shape[0]
        r, v, w = (x.clone() for x in inits)
        r[:k], v[:k], w[:k] = seed.r, seed.v, seed.w
        if n_starts >= k + 1:
            r[k], v[k], w[k] = seed.r[0], seed.v[0], -seed.w[0]
        inits = BallState(r, v, w)
        seed_q = _state_to_params(BallState(*(x[0] for x in seed)))
    return _run_fit(_state_to_params(inits), obs, times, mask, Mint, Mext, n_frames=n_frames,
                    substeps=substeps, dt=dt, adam_steps=adam_steps, lm_steps=lm_steps, lr=lr,
                    huber_px=huber_px, seed_q=seed_q, seed_rel=seed_select_rel)


def fit_trajectory_batch(obs, times, mask, Mint, Mext, *, n_frames: int,
                         generator: Optional[torch.Generator] = None, n_starts: int = 32,
                         adam_steps: int = 250, lm_steps: int = 12, lr: float = 0.03,
                         substeps: int = SUBSTEPS, dt: float = DT,
                         huber_px: Optional[float] = None,
                         init_state: Optional[BallState] = None,
                         seed_select_rel: float = 1.3, draws: Optional[Sequence[dict]] = None,
                         device="cuda") -> FitResult:
    """Fit B tracks at once: obs (B, T, 2), times, mask (B, T), Mint (B, 3, 3), Mext
    (B, 4, 4); n_frames covers every track's visible times. All B * n_starts starts
    integrate in one S1 launch per physics call. `init_state` (fields (B, 3)) seeds
    start 0 of each track with an external prediction and start 1 with its spin-flipped
    copy, and the winner is then picked by the seed-aware rule. `draws` (B dicts of
    `draw_inits`, one per track) gives the starts' draws in place of `generator`'s.
    Returns a FitResult of (B, ...) tensors."""
    dev = resolve_device(device)
    obs, times, mask, Mint, Mext = (_f32(a, dev) for a in (obs, times, mask, Mint, Mext))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if draws is None:
        starts = [default_inits(obs[b], times[b], mask[b], Mint[b], Mext[b], n_starts,
                                generator) for b in range(obs.shape[0])]
    else:
        starts = [inits_from_draws({k: _f32(v, dev) for k, v in draws[b].items()}, obs[b],
                                   times[b], mask[b], Mint[b], Mext[b])
                  for b in range(obs.shape[0])]
    r, v, w = (torch.stack(x) for x in zip(*starts))
    seed_q = None
    if init_state is not None:
        seed = BallState(*(_f32(a, dev) for a in init_state))
        r[:, 0], v[:, 0], w[:, 0] = seed.r, seed.v, seed.w
        if n_starts >= 2:  # the spin sign is the hard part: seed the flip too
            r[:, 1], v[:, 1], w[:, 1] = seed.r, seed.v, -seed.w
        seed_q = _state_to_params(seed)
    return _run_fit_batched(
        _state_to_params(BallState(r, v, w)), obs, times, mask, Mint[:, :3, :3], Mext,
        n_frames=n_frames, substeps=substeps, dt=dt, adam_steps=adam_steps, lm_steps=lm_steps,
        lr=lr, huber_px=huber_px, seed_q=seed_q, seed_rel=seed_select_rel)


def spin_class_from_fit(result: FitResult) -> torch.Tensor:
    """The paper's spin label of a fit: 1.0 if the flight-frame w_y of the fitted initial
    spin is positive, else 2.0."""
    w_local = G.transform_rotation_axes(result.state0.w, result.r_world)
    return torch.where(w_local[..., 1] > 0, 1.0, 2.0)
