"""Parity checks for quantities that a chaotic step sets, shared by the tests that hold the
port against the JAX package and by tests/test_torch_parity_faults.py, which shows that
each check still rejects a planted fault.

Each check holds the function at a level that no host's rounding moves:

* Peaks (`ops/peak.py`, a fixed 20-step projected Levenberg-Marquardt fit in f32). On a
  flat peak the fit's f32 accept test goes one way or the other on rounding alone, so the
  JAX fit itself moves by more than a test's tolerance when its heatmaps move by one
  rounding. A peak is *well conditioned* when the JAX fit moves by less than `PEAK_PX`
  under each of `PERTURB_DRAWS` seeded uniform perturbations of the heatmaps within the
  heatmap tolerance. A well-conditioned peak must agree within `PEAK_PX`; on any other the
  port's fit must be no worse than JAX's: the mean squared residual over the peak's 3x3
  window of the best Gaussian (amplitude 1, widths within the fit's bounds) centred where
  the port put the peak is at most JAX's plus `RESIDUAL_TOL`. Visibility is exact.
* RANSAC hypotheses (`core/calibration.py`: multistart LM on 6 near-planar points, in
  f64). Which hypotheses the two packages' LM runs part on is set by rounding, so the
  inlier counts of those hypotheses and the index of the first one with the most are too.
  At least `HYP_AGREE` of the hypotheses' cameras agree within `HYP_PX`; where a camera
  agrees and no keypoint of it lies within `HYP_PX` of the inlier threshold, the inlier
  counts are equal; the port's winner has the most inliers, as many as JAX's winner, and
  its camera agrees within `WINNER_PX` with JAX's camera of the same hypothesis.
* Gradients through ReLU (the uplifting model in f32). A unit whose pre-activation lies
  within f32 rounding of zero (`knife_edges`: within `KNIFE_REL` of its activation's max
  |value| in the float64 forward) is on in one package and off in the other as the host
  rounds; the gradient it passes when on reaches every parameter upstream of it, by a few
  1e-4 of a tensor's max. So each gradient tensor must agree within its tolerance once
  some choice of each knife-edge unit's contribution (-1, 0 or +1 times the gradient it
  passes, worked out in float64) is taken from the difference (`check_gradients`); a
  tensor that no such unit reaches is held as before.
"""
import itertools

import numpy as np
import torch
from scipy.optimize import minimize

PEAK_PX = 5e-2  # at 1920x1080
RESIDUAL_TOL = 1e-6
PERTURB_DRAWS = 8
SIGMA_BOUNDS = (0.5, 50.0)  # the fit's bounds of sigma_x and sigma_y (ops/peak.py)
HYP_PX, HYP_AGREE, WINNER_PX = 1e-2, 75, 5e-2
KNIFE_REL = 1e-6


def ill_conditioned_peaks(jax_peaks, heatmaps, tol):
    """Mask (...,) of the peaks whose JAX position, `jax_peaks(heatmaps)` (..., 3), moves by
    PEAK_PX or more in x or y under one of PERTURB_DRAWS seeded uniform perturbations of
    the heatmaps (..., H, W) within +-tol."""
    base = jax_peaks(heatmaps)[..., :2]
    rng = np.random.default_rng(0)
    move = np.zeros(base.shape[:-1])
    for _ in range(PERTURB_DRAWS):
        noisy = heatmaps + rng.uniform(-tol, tol, heatmaps.shape).astype(heatmaps.dtype)
        move = np.maximum(move, np.abs(jax_peaks(noisy)[..., :2] - base).max(-1))
    return move >= PEAK_PX


def peak_residuals(heatmaps, pos, width, height):
    """(...,) for peaks pos (..., 3) in image pixels of heatmaps (..., H, W): the mean squared
    residual over the zero-padded 3x3 window at each heatmap's argmax of the best Gaussian
    (amplitude 1, sigma_x and sigma_y within SIGMA_BOUNDS) centred at the peak, in f64."""
    H, W = heatmaps.shape[-2:]
    flat = heatmaps.reshape(-1, H, W).astype(np.float64)
    padded = np.pad(flat, ((0, 0), (1, 1), (1, 1)))
    xy = pos.reshape(-1, 3)[:, :2].astype(np.float64)
    gy, gx = np.mgrid[0:3, 0:3].astype(np.float64)
    log_lo, log_hi = np.log(SIGMA_BOUNDS)
    grid = np.linspace(log_lo, log_hi, 21)
    out = np.empty(len(flat))
    for b in range(len(flat)):
        y_max, x_max = divmod(int(flat[b].argmax()), W)
        window = padded[b, y_max:y_max + 3, x_max:x_max + 3]
        x0 = (xy[b, 0] + 0.5) * W / width - 0.5 - (x_max - 1)  # window coordinates
        y0 = (xy[b, 1] + 0.5) * H / height - 0.5 - (y_max - 1)

        def mse(log_sigma):
            sx, sy = np.exp(log_sigma)
            g = np.exp(-((gx - x0) ** 2 / (2 * sx**2) + (gy - y0) ** 2 / (2 * sy**2)))
            return float(((g - window) ** 2).mean())

        start = min(((a, c) for a in grid for c in grid), key=mse)
        fit = minimize(mse, start, bounds=[(log_lo, log_hi)] * 2, method="L-BFGS-B")
        out[b] = min(fit.fun, mse(start))
    return out.reshape(pos.shape[:-1])


def check_peaks(pos, jpos, heatmaps, ill, width, height):
    """Raises AssertionError unless the port's peaks `pos` and JAX's `jpos` (..., 3), both
    from `heatmaps` (..., H, W) at width x height, agree as the module docstring says; `ill`
    is `ill_conditioned_peaks`'s mask."""
    pos, jpos = np.asarray(pos), np.asarray(jpos)
    assert pos.shape == jpos.shape == (*ill.shape, 3), (pos.shape, jpos.shape, ill.shape)
    np.testing.assert_array_equal(pos[..., 2], jpos[..., 2])
    off = np.abs(pos[..., :2] - jpos[..., :2]).max(-1)
    assert (off[~ill] <= PEAK_PX).all(), \
        f"well-conditioned peaks off by {np.sort(off[~ill])[-3:]} px (limit {PEAK_PX})"
    if ill.any():
        res = peak_residuals(heatmaps, pos, width, height)[ill]
        res_j = peak_residuals(heatmaps, jpos, width, height)[ill]
        assert (res <= res_j + RESIDUAL_TOL).all(), \
            f"ill-conditioned peaks fit worse than JAX's by {(res - res_j).max():.3e}"


def check_hypotheses(err, err_j, n_in, best, n_in_j, threshold):
    """Raises AssertionError unless the port's RANSAC hypotheses agree with JAX's as the
    module docstring says. err, err_j (N, 13): each package's reprojection distances of its
    N hypothesis cameras from the same weights; n_in (N,) and best: the port's inlier counts
    and winner; n_in_j (N,): JAX's counts; threshold: JAX's inlier threshold in px."""
    err, err_j, n_in, n_in_j = (np.asarray(a) for a in (err, err_j, n_in, n_in_j))
    best = int(best)
    agree = np.abs(err - err_j).max(1) < HYP_PX
    assert agree.sum() >= HYP_AGREE, f"{agree.sum()} hypotheses agree (at least {HYP_AGREE})"
    assert n_in.shape == n_in_j.shape and 0 <= best < len(n_in), (n_in.shape, best)
    edge = ((np.abs(err - threshold) < HYP_PX) | (np.abs(err_j - threshold) < HYP_PX)).any(1)
    steady = agree & ~edge
    differ = np.nonzero(n_in[steady] != n_in_j[steady])[0]
    assert differ.size == 0, f"agreeing hypotheses {np.nonzero(steady)[0][differ]} count " \
                             f"other inliers"
    assert n_in[best] == n_in.max() == n_in_j.max(), (n_in[best], n_in.max(), n_in_j.max())
    winner_px = np.abs(err[best] - err_j[best]).max()
    assert winner_px < WINNER_PX, f"winner {best} is {winner_px:.3g} px from JAX's"


def knife_edges(model64, loss_of, limit):
    """The ReLU units of the port's uplifting model `model64` (float64) whose pre-activation
    in `loss_of(model64)`'s forward lies within KNIFE_REL of zero, relative to its
    activation's max |value|, but is not 0 (a padded token's units are exactly 0 in every
    package): a list of (module name, unit index, the gradient the unit passes when on:
    one float64 array per parameter, in parameters() order). Raises AssertionError when
    there are more than `limit`."""
    relus = {"Mlp2": (("fc1", "fc2"),), "Head3": (("fc1", "fc2"), ("fc2", "fc3"))}
    pre, post, hooks = {}, {}, []
    for name, module in model64.named_modules():
        pairs = relus.get(type(module).__name__, ())  # (Linear before, Linear after)
        for a, b in pairs:
            key = f"{name}.{a}"
            hooks.append(getattr(module, a).register_forward_hook(
                lambda m, i, o, key=key: pre.setdefault(key, []).append(o)))
            hooks.append(getattr(module, b).register_forward_pre_hook(
                lambda m, i, key=key: post.setdefault(key, []).append(i[0])))
    try:
        loss = loss_of(model64)
    finally:
        for h in hooks:
            h.remove()
    assert all(len(v) == 1 for v in (*pre.values(), *post.values())), "a module ran twice"
    params = list(model64.parameters())
    keys = sorted(pre)
    post_grads = torch.autograd.grad(loss, [post[k][0] for k in keys], retain_graph=True)
    found = [(key, g_post, idx) for key, g_post in zip(keys, post_grads)
             for idx in torch.nonzero((pre[key][0] != 0) & (pre[key][0].abs() < KNIFE_REL
                                                            * pre[key][0].abs().max())).tolist()]
    assert len(found) <= limit, f"{len(found)} knife-edge units (at most {limit})"
    units = []
    for key, g_post, idx in found:
        idx = tuple(idx)
        dz = torch.autograd.grad(pre[key][0][idx], params, retain_graph=True, allow_unused=True)
        units.append((key, idx, [np.zeros(tuple(p.shape)) if d is None else
                                 (g_post[idx] * d).detach().numpy() for p, d in zip(params, dz)]))
    return units


def check_gradients(names, grads, grads_j, units, tol):
    """Raises AssertionError unless each gradient tensor of the port (`grads`) agrees with
    JAX's (`grads_j`), both f32, within `tol` of the JAX tensor's max |value|, after some
    choice of -1, 0 or +1 times each knife-edge unit's contribution (`units`, from
    `knife_edges`) is taken from the difference."""
    choices = np.array(list(itertools.product((-1.0, 0.0, 1.0), repeat=len(units))))
    for i, (name, g, w) in enumerate(zip(names, grads, grads_j)):
        diff = np.asarray(g, np.float64) - np.asarray(w, np.float64)
        scale = max(np.abs(np.asarray(w)).max(), 1e-30)
        reach = [u for u, (_, _, d) in enumerate(units) if np.any(d[i])]
        if not reach:
            off = np.abs(diff).max() / scale
        else:
            deltas = np.stack([units[u][2][i] for u in reach])  # (k, ...)
            sub = np.unique(choices[:, reach], axis=0)  # (3^k, k)
            off = min(np.abs(diff - np.tensordot(c, deltas, 1)).max() for c in sub) / scale
        assert off <= tol, f"{name}: {off:.3e} of its max from JAX's (limit {tol}); " \
                           f"knife-edge units reaching it: {[units[u][:2] for u in reach]}"
