"""flax's BatchNorm on NHWC tensors, shared by the SegFormer heads and the HRNets.

flax `nn.BatchNorm(momentum=0.9)` in training normalises by the batch's mean and
*biased* variance max(0, E[x²] - E[x]²), and moves its running statistics as
ra = 0.9 ra + 0.1 stat. `nn.BatchNorm2d` uses the unbiased variance at momentum 0.1,
so the port keeps the module (its parameters and buffers, for the state-dict keys)
and computes flax's rule here.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

FLAX_BN_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 stat

__all__ = ["FLAX_BN_MOMENTUM", "batch_norm", "batch_stats", "update_running_stats"]

Stats = List[Tuple[nn.BatchNorm2d, torch.Tensor, torch.Tensor]]


def batch_stats(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last, of an f32 tensor."""
    dims = tuple(range(xf.ndim - 1))
    mean = xf.mean(dims)
    return mean, torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """One flax update of `bn`'s running statistics by a batch's mean and variance."""
    m = FLAX_BN_MOMENTUM
    bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean.detach())
    bn.running_var.copy_(m * bn.running_var + (1 - m) * var.detach())
    bn.num_batches_tracked += 1


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, sink: Optional[Stats] = None):
    """BatchNorm over the last (channel) axis of `x`, in f32, rounded to x.dtype.

    Inference (bn.training False): the running statistics. Training: the batch's
    statistics; the running statistics move by them at once, or, when `sink` is a
    list, later: (bn, mean, var) is appended for the caller to apply with
    `update_running_stats` (a checkpointed block reruns its forward in the backward,
    and must not move them twice)."""
    xf = x.float()
    if bn.training:
        mean, var = batch_stats(xf)
        if sink is None:
            update_running_stats(bn, mean, var)
        else:
            sink.append((bn, mean, var))
        y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight.float())
        return (y + bn.bias.float()).to(x.dtype)
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return (xf * scale + (bn.bias.float() - bn.running_mean.float() * scale)).to(x.dtype)
