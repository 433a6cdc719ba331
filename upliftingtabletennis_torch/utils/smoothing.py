"""Temporal keypoint smoothing: the One Euro filter.

Port of `upliftingtabletennis_tpu/utils/smoothing.py`: an adaptive low-pass filter whose
cutoff rises with speed (little jitter when still, little lag when moving). Two forms: the
stateful `OneEuroFilter` on the host in numpy (the reference's API), and
`one_euro_trajectory` over a whole trajectory in torch on the input's device, a loop over
time vectorised over the trailing axes (JAX's `lax.scan`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["OneEuroFilter", "one_euro_trajectory"]


def _smoothing_factor(t_e, cutoff):
    r = 2 * math.pi * cutoff * t_e
    return r / (r + 1)


def _exp_smooth(a, x, x_prev):
    return a * x + (1 - a) * x_prev


class OneEuroFilter:
    """The stateful filter of a scalar or an array, one sample per call."""

    def __init__(self, t0, x0, dx0=0.0, min_cutoff=1.7, beta=0.3, d_cutoff=30.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.asarray(x0, float)
        self.dx_prev = np.full_like(self.x_prev, dx0)
        self.t_prev = float(t0)

    def __call__(self, t, x):
        t_e = t - self.t_prev
        x = np.asarray(x, float)
        a_d = _smoothing_factor(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = _exp_smooth(a_d, dx, self.dx_prev)
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = 2 * math.pi * cutoff * t_e / (2 * math.pi * cutoff * t_e + 1)
        x_hat = a * x + (1 - a) * self.x_prev
        self.x_prev = x_hat
        self.dx_prev = dx_hat
        self.t_prev = t
        return x_hat


def one_euro_trajectory(times, xs, min_cutoff=1.7, beta=0.3, d_cutoff=30.0) -> torch.Tensor:
    """A whole trajectory: times (T,), xs (T, ...) -> the smoothed xs (T, ...), on xs's
    device (a tensor) or the CPU (an array); the first sample is kept."""
    xs = torch.as_tensor(xs)
    times = torch.as_tensor(times, device=xs.device)
    out = [xs[0]]
    x_prev, dx_prev, t_prev = xs[0], torch.zeros_like(xs[0]), times[0]
    for t, x in zip(times[1:], xs[1:]):
        t_e = t - t_prev
        r_d = 2 * math.pi * d_cutoff * t_e
        a_d = r_d / (r_d + 1)
        dx = (x - x_prev) / t_e
        dx_hat = a_d * dx + (1 - a_d) * dx_prev
        cutoff = min_cutoff + beta * torch.abs(dx_hat)
        r = 2 * math.pi * cutoff * t_e
        a = r / (r + 1)
        x_prev = a * x + (1 - a) * x_prev
        dx_prev, t_prev = dx_hat, t
        out.append(x_prev)
    return torch.stack(out)
