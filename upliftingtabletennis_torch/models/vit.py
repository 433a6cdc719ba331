"""ViTPose: a plain ViT backbone and a deconvolution heatmap head, NHWC in and out.

Port of `upliftingtabletennis_tpu/models/vit.py` for inference:

* patch embedding: conv k16 s16, padding 2, so the token grid of an H x W
  input is floor((H + 4 - 16) / 16) + 1 by the same of W (40 x 72 at
  1152x640);
* a position embedding of grid + 1 rows, added as x + pos[:, 1:] + pos[:, :1].
  Its length depends on the input resolution, so a model is built for one
  resolution (the flax module sizes it at `init` from its input);
* 12 pre-LN blocks: LayerNorm (eps 1e-6), qkv and output projections with
  biases, 12 heads, a GELU (erf) MLP of ratio 4; then a last LayerNorm;
* the head: twice ConvTranspose2d(k4, s2, p1, no bias), BatchNorm on its
  running statistics, ReLU (256 filters); then a 1x1 conv to the outputs.
  The heatmap is a quarter of the input's size.

Modules are named after the flax tree (`model_backbone.patch_embed_proj`,
`.pos_embed`, `.blocks_{i}.{norm1, attn_qkv, attn_proj, norm2, mlp_fc1,
mlp_fc2}`, `.last_norm`, `model_keypoint_head.deconv_layers_{0,1,3,4}`,
`.final_layer`), so `utils/convert.py:flax_to_torch` is a path walk.

No TPU kernel stands behind this model: the JAX package computes attention
with XLA einsums. With `sdpa=True` (the detector's path) a CUDA tensor's
attention runs through `F.scaled_dot_product_attention`; a CPU tensor, and
every tensor with `sdpa=False` (the f32 comparison copy on the card), take
the einsum-and-softmax form of the JAX module. Stochastic depth is for
training only and has no parameters, so it is left out.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ViTBlock", "ViTBackbone", "HeatmapHead", "VitPoseNet", "patch_grid"]

EMBED_DIMS = {"small": 384, "base": 768}
PATCH, PATCH_PAD = 16, 2  # the reference's padding formula 4 + 2 * (ratio // 2 - 1) at ratio 1


def patch_grid(height: int, width: int) -> Tuple[int, int]:
    """Token grid (Hp, Wp) of the patch embedding for an input of height x width."""
    return ((height + 2 * PATCH_PAD - PATCH) // PATCH + 1,
            (width + 2 * PATCH_PAD - PATCH) // PATCH + 1)


class ViTBlock(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, sdpa: bool = True):
        super().__init__()
        self.num_heads, self.sdpa = num_heads, sdpa
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn_qkv = nn.Linear(dim, 3 * dim)
        self.attn_proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _attn(self, y: torch.Tensor) -> torch.Tensor:
        B, N, C = y.shape
        h = self.num_heads
        q, k, v = self.attn_qkv(y).view(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)  # (B, h, N, hd)
        if self.sdpa and y.device.type == "cuda":
            o = F.scaled_dot_product_attention(q, k, v)
        else:
            logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (C // h) ** -0.5
            o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
        return self.attn_proj(o.transpose(1, 2).reshape(B, N, C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attn(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class ViTBackbone(nn.Module):
    """Plain ViT: (B, H, W, in_chans) -> (B, Hp, Wp, embed_dim) features."""

    def __init__(self, grid: Tuple[int, int], embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 12, in_chans: int = 3, sdpa: bool = True):
        super().__init__()
        self.grid, self.depth = tuple(grid), depth
        self.patch_embed_proj = nn.Conv2d(in_chans, embed_dim, PATCH, stride=PATCH,
                                          padding=PATCH_PAD)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", ViTBlock(embed_dim, num_heads, 4.0, sdpa))
        self.last_norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed_proj(x.permute(0, 3, 1, 2))  # (B, D, Hp, Wp)
        B, D, Hp, Wp = x.shape
        if (Hp, Wp) != self.grid:
            raise ValueError(f"input gives a {Hp}x{Wp} token grid; the model was built for "
                             f"{self.grid[0]}x{self.grid[1]}")
        x = x.flatten(2).transpose(1, 2)  # (B, Hp * Wp, D), row-major over the grid
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        return self.last_norm(x).view(B, Hp, Wp, D)


class HeatmapHead(nn.Module):
    """Two [ConvTranspose k4 s2 p1, BatchNorm, ReLU] and a 1x1 conv, NHWC in and out."""

    def __init__(self, in_channels: int, out_channels: int = 1, filters: int = 256):
        super().__init__()
        self.deconv_layers_0 = nn.ConvTranspose2d(in_channels, filters, 4, stride=2, padding=1,
                                                  bias=False)
        self.deconv_layers_1 = nn.BatchNorm2d(filters)
        self.deconv_layers_3 = nn.ConvTranspose2d(filters, filters, 4, stride=2, padding=1,
                                                  bias=False)
        self.deconv_layers_4 = nn.BatchNorm2d(filters)
        self.final_layer = nn.Conv2d(filters, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.deconv_layers_1(self.deconv_layers_0(x)))
        x = F.relu(self.deconv_layers_4(self.deconv_layers_3(x)))
        return self.final_layer(x).permute(0, 2, 3, 1)


class VitPoseNet(nn.Module):
    """Ball (1 output, 3 frames) or table (13 outputs, 1 frame) detector at one resolution.

    Input (B, H, W, 3 * in_frames) with (W, H) = `resolution`; output
    (heatmap (B, H / 4, W / 4, out_channels), None), as the JAX model returns.
    """

    def __init__(self, out_channels: int = 1, in_frames: int = 3, model_size: str = "small",
                 resolution: Tuple[int, int] = (1152, 640), sdpa: bool = True):
        super().__init__()
        if model_size not in EMBED_DIMS:
            raise ValueError(f"unknown model_size {model_size!r}")
        dim = EMBED_DIMS[model_size]
        W, H = resolution
        self.model_backbone = ViTBackbone(patch_grid(H, W), dim, 12, 12, 3 * in_frames, sdpa)
        self.model_keypoint_head = HeatmapHead(dim, out_channels, 256)

    def forward(self, x: torch.Tensor):
        return self.model_keypoint_head(self.model_backbone(x)), None
