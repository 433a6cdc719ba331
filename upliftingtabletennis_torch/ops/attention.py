"""Rotary embedding over time and the symmetrically masked attention of the uplifting model.

Port of `upliftingtabletennis_tpu/ops/attention.py`. The JAX module computes these in
XLA, not in a Pallas kernel (at most 51 ball tokens or 14 table tokens per sequence), so
plain PyTorch is their counterpart here too.

* Positions are round(t * MAX_FPS) (round half to even, as `jnp.round`), and the rotated
  pairs are interleaved: channels (0, 1), (2, 3), ...
* The additive mask is applied on both the query and the key axis. A padded query row is
  shifted by NEG_INF as a whole, so in f32 its logits round to the same value and it gets
  a uniform softmax over the valid keys (never NaN). This is not SDPA's `attn_mask`, so
  the attention stays a plain einsum softmax.
"""
from __future__ import annotations

import torch

from upliftingtabletennis_torch.core.geometry import MAX_FPS

__all__ = ["NEG_INF", "rope_angles", "apply_rope_over_time", "masked_attention",
           "binarize_mask"]

NEG_INF = -1e9


def rope_angles(times: torch.Tensor, head_dim: int) -> torch.Tensor:
    """times (..., N) in seconds -> rotation angles (..., N, head_dim // 2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=times.device) / head_dim
    inv_freq = 1.0 / (10000.0 ** exponent)
    pos = torch.round(times * MAX_FPS)
    return pos[..., None] * inv_freq


def apply_rope_over_time(x: torch.Tensor, times: torch.Tensor,
                         time_rotation: str = "new") -> torch.Tensor:
    """x (..., H, N, Dh) rotated by the positions of times (..., N), broadcast over heads.

    time_rotation 'new': positions from the timestamps; 'old': the sequence index."""
    head_dim = x.shape[-1]
    if time_rotation == "new":
        t = times
    elif time_rotation == "old":
        n = x.shape[-2]
        idx = torch.arange(n, dtype=x.dtype, device=x.device) / MAX_FPS
        t = idx.expand(*times.shape[:-1], n)
    else:
        raise ValueError(f"unknown time_rotation {time_rotation!r}")
    freqs = rope_angles(t, head_dim)
    cos = torch.cos(freqs)[..., None, :, :]  # (..., 1, N, Dh/2): broadcast over heads
    sin = torch.sin(freqs)[..., None, :, :]
    xr = x.reshape(*x.shape[:-1], head_dim // 2, 2)
    x_u, x_e = xr[..., 0], xr[..., 1]
    out = torch.stack([x_u * cos - x_e * sin, x_u * sin + x_e * cos], dim=-1)
    return out.reshape(x.shape)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_add: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(Dh) + m_q + m_k) v. q, k, v (..., H, N, Dh); mask_add (..., N)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...hqd,...hkd->...hqk", q, k) * scale
    logits = logits + (mask_add[..., None, :, None] + mask_add[..., None, None, :])
    return torch.einsum("...hqk,...hkd->...hqd", torch.softmax(logits, dim=-1), v)


def binarize_mask(mask: torch.Tensor) -> torch.Tensor:
    """A {0, 1} validity mask -> an additive {NEG_INF, 0} bias; a mask that is already
    additive (min < -1e8) passes through."""
    binary = torch.where(mask > 0.5, 0.0, NEG_INF).to(mask.dtype)
    return torch.where(mask.min() < -1e8, mask, binary)
