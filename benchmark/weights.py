"""Seeded random weights, made by the benchmark on the device and handed to both the port
and the plain reference (neither side makes its own).

One draw from a `torch.Generator` on the device per model: every tensor whose name ends in
`bias` is 0, any other 1-D tensor (a norm's scale) is 1, the rest N(0, 1/fan_in), fan_in
the elements of one output slice; BatchNorm statistics are 0 (mean) and 1 (variance).
Each model's weights are made in the type it is served in.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def meta_module(build) -> nn.Module:
    """A module built on the meta device (shapes only, no storage)."""
    with torch.device("meta"):
        return build()


def make_state(template: nn.Module, gen: torch.Generator, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """A full state dict for `template`'s keys and shapes."""
    state = template.state_dict()
    drawn = [k for k, v in state.items() if v.is_floating_point() and v.ndim >= 2]
    total = sum(state[k].numel() for k in drawn)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in state.items():
        if k in drawn:
            n = v.numel()
            fan_in = n // v.shape[0]
            out[k] = (flat[at:at + n].reshape(v.shape) * fan_in ** -0.5).to(dtype)
            at += n
        elif not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
        elif k.endswith("bias") or k.endswith("running_mean"):
            out[k] = torch.zeros(v.shape, dtype=dtype, device=device)
        else:  # norm scales, running variances
            out[k] = torch.ones(v.shape, dtype=dtype, device=device)
    return out


def materialise(build, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """The reference module of `build`, on `device` in float32, holding `state`."""
    module = meta_module(build).to_empty(device=device)
    module.load_state_dict({k: v.float() if v.is_floating_point() else v
                            for k, v in state.items()})
    return module.float().eval()
