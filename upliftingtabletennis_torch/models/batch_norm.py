"""flax's BatchNorm on NHWC tensors, shared by the SegFormer heads and the HRNets.

flax `nn.BatchNorm(momentum=0.9)` in training normalises by the batch's mean and
*biased* variance max(0, E[x²] - E[x]²), and moves its running statistics as
ra = 0.9 ra + 0.1 stat. `nn.BatchNorm2d` uses the unbiased variance at momentum 0.1,
so the port keeps the module (its parameters and buffers, for the state-dict keys)
and computes flax's rule here.

Data parallelism: JAX's sharded step computes the statistics over the global batch.
`sync_batch_stats(model)` marks every BatchNorm of a model so that its batch statistics
average E[x] and E[x²] over the ranks of the default `torch.distributed` group (equal local
batches), by the autograd-aware all-reduce of `torch.distributed.nn`, so that the
gradients flow across ranks as well; an unmarked BatchNorm keeps its process's statistics.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

FLAX_BN_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 stat

__all__ = ["FLAX_BN_MOMENTUM", "batch_norm", "batch_stats", "update_running_stats",
           "sync_batch_stats"]

Stats = List[Tuple[nn.BatchNorm2d, torch.Tensor, torch.Tensor]]


def sync_batch_stats(model: nn.Module) -> None:
    """Take the batch statistics of every BatchNorm of `model` over the ranks of the
    default process group."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.sync_stats = True


def batch_stats(xf: torch.Tensor, sync: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last, of an f32 (or f64) tensor;
    with `sync`, over the global batch of the default process group's ranks."""
    dims = tuple(range(xf.ndim - 1))
    mean, sq = xf.mean(dims), (xf * xf).mean(dims)
    if sync:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        both = all_reduce(torch.stack([mean, sq])) / dist.get_world_size()
        mean, sq = both[0], both[1]
    return mean, torch.clamp(sq - mean * mean, min=0.0)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """One flax update of `bn`'s running statistics by a batch's mean and variance."""
    m = FLAX_BN_MOMENTUM
    bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean.detach())
    bn.running_var.copy_(m * bn.running_var + (1 - m) * var.detach())
    bn.num_batches_tracked += 1


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, sink: Optional[Stats] = None):
    """BatchNorm over the last (channel) axis of `x`, in f32 (f64 for an f64 `x`), rounded
    to x.dtype.

    Inference (bn.training False): the running statistics. Training: the batch's
    statistics; the running statistics move by them at once, or, when `sink` is a
    list, later: (bn, mean, var) is appended for the caller to apply with
    `update_running_stats` (a checkpointed block reruns its forward in the backward,
    and must not move them twice)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32, or f64 for f64
    if bn.training:
        mean, var = batch_stats(xf, getattr(bn, "sync_stats", False))
        if sink is None:
            update_running_stats(bn, mean, var)
        else:
            sink.append((bn, mean, var))
        y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight.to(xf.dtype))
        return (y + bn.bias.to(xf.dtype)).to(x.dtype)
    scale = bn.weight.to(xf.dtype) * torch.rsqrt(bn.running_var.to(xf.dtype) + bn.eps)
    return (xf * scale + (bn.bias.to(xf.dtype) - bn.running_mean.to(xf.dtype) * scale)).to(x.dtype)
