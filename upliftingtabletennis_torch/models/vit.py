"""ViTPose: a plain ViT backbone and a deconvolution heatmap head, NHWC in and out.

Port of `upliftingtabletennis_tpu/models/vit.py`, for inference and training:

* patch embedding: conv k16 s16, padding 2, so the token grid of an H x W
  input is floor((H + 4 - 16) / 16) + 1 by the same of W (40 x 72 at
  1152x640);
* a position embedding of grid + 1 rows, added as x + pos[:, 1:] + pos[:, :1].
  Its length depends on the input resolution, so a model is built for one
  resolution (the flax module sizes it at `init` from its input);
* 12 pre-LN blocks: LayerNorm (eps 1e-6), qkv and output projections with
  biases, 12 heads, a GELU (erf) MLP of ratio 4; then a last LayerNorm;
* the head: twice ConvTranspose2d(k4, s2, p1, no bias), BatchNorm, ReLU (256
  filters); then a 1x1 conv to the outputs. The heatmap is a quarter of the
  input's size.

Training mode (`model.train()`, as the JAX module's `train=True`) adds:

* stochastic depth on both residual branches of each block: block i drops its
  branch for a whole sample with probability `DROP_PATH_RATE * i / (depth - 1)`
  (0 for block 0, 0.3 for the last at the default rate) and scales a kept one
  by 1 / keep, as `y * mask / keep`. The masks are explicit: `forward(x,
  drop_masks)` takes a (depth, 2, B) {0, 1} tensor, which the trainer draws from
  its own `torch.Generator` (`draw_drop_masks`) and the tests take from JAX's draws;
* the head's BatchNorms on the batch statistics, with flax's rule
  (`models/batch_norm.py`: biased variance, running statistics at momentum 0.9,
  shared over the ranks of a data-parallel run).

Modules are named after the flax tree (`model_backbone.patch_embed_proj`,
`.pos_embed`, `.blocks_{i}.{norm1, attn_qkv, attn_proj, norm2, mlp_fc1,
mlp_fc2}`, `.last_norm`, `model_keypoint_head.deconv_layers_{0,1,3,4}`,
`.final_layer`), so `utils/convert.py:flax_to_torch` is a path walk. Every
parameter is cast to the activation dtype where it is used, so f32 weights
train under a bf16 forward; a model cast to bf16 (the detector) casts nothing.

No TPU kernel stands behind this model: the JAX package computes attention
with XLA einsums. With `sdpa=True` (the detector's and the trainer's path) a
CUDA tensor's attention runs through `F.scaled_dot_product_attention`; a CPU
tensor, and every tensor with `sdpa=False` (the f32 comparison copy on the
card), take the einsum-and-softmax form of the JAX module.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from upliftingtabletennis_torch.models.batch_norm import batch_norm

__all__ = ["ViTBlock", "ViTBackbone", "HeatmapHead", "VitPoseNet", "patch_grid",
           "drop_path_rates", "draw_drop_masks", "DROP_PATH_RATE"]

EMBED_DIMS = {"small": 384, "base": 768}
PATCH, PATCH_PAD = 16, 2  # the reference's padding formula 4 + 2 * (ratio // 2 - 1) at ratio 1
DEPTH = 12
DROP_PATH_RATE = 0.3  # the JAX model's default (models/vit.py:153)


def patch_grid(height: int, width: int) -> Tuple[int, int]:
    """Token grid (Hp, Wp) of the patch embedding for an input of height x width."""
    return ((height + 2 * PATCH_PAD - PATCH) // PATCH + 1,
            (width + 2 * PATCH_PAD - PATCH) // PATCH + 1)


def drop_path_rates(depth: int = DEPTH):
    """Block i's drop probability, rising linearly from 0 to DROP_PATH_RATE over the
    depth."""
    return [DROP_PATH_RATE * i / max(depth - 1, 1) for i in range(depth)]


def draw_drop_masks(generator: torch.Generator, batch: int, device=None) -> torch.Tensor:
    """(depth, 2, batch) {0, 1} keep masks of the two residual branches of each block, one
    Bernoulli(1 - rate_i) per sample, drawn on the generator's device (then moved to
    `device`); a block of rate 0 draws nothing and keeps every sample."""
    dev = generator.device
    masks = torch.ones(DEPTH, 2, batch, device=dev)
    for i, dp in enumerate(drop_path_rates()):
        if dp > 0.0:
            masks[i] = torch.bernoulli(torch.full((2, batch), 1.0 - dp, device=dev),
                                       generator=generator)
    return masks.to(device or dev)


def _linear(x, lin: nn.Linear):
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _drop_path(y, mask, keep: float):
    """y (B, N, C) * mask (B,) / keep, in the JAX module's order."""
    return y * mask.to(y.dtype)[:, None, None] / keep


class ViTBlock(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)), then x + MLP(LN(x)); in training, each
    branch through stochastic depth at rate `drop_path`."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, sdpa: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads, self.sdpa, self.drop_path = num_heads, sdpa, drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn_qkv = nn.Linear(dim, 3 * dim)
        self.attn_proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _attn(self, y: torch.Tensor) -> torch.Tensor:
        B, N, C = y.shape
        h = self.num_heads
        q, k, v = _linear(y, self.attn_qkv).view(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        if self.sdpa and y.device.type == "cuda":
            o = F.scaled_dot_product_attention(q, k, v)
        else:
            logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (C // h) ** -0.5
            o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
        return _linear(o.transpose(1, 2).reshape(B, N, C), self.attn_proj)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: (2, B) keep masks of the two branches, or None (no stochastic depth)."""
        drop = mask is not None and self.drop_path > 0.0
        keep = 1.0 - self.drop_path
        a = self._attn(_layer_norm(x, self.norm1))
        x = x + (_drop_path(a, mask[0], keep) if drop else a)
        y = _linear(F.gelu(_linear(_layer_norm(x, self.norm2), self.mlp_fc1)), self.mlp_fc2)
        return x + (_drop_path(y, mask[1], keep) if drop else y)


class ViTBackbone(nn.Module):
    """Plain ViT: (B, H, W, in_chans) -> (B, Hp, Wp, embed_dim) features."""

    def __init__(self, grid: Tuple[int, int], embed_dim: int = 384, depth: int = DEPTH,
                 num_heads: int = 12, in_chans: int = 3, sdpa: bool = True):
        super().__init__()
        self.grid, self.depth = tuple(grid), depth
        self.patch_embed_proj = nn.Conv2d(in_chans, embed_dim, PATCH, stride=PATCH,
                                          padding=PATCH_PAD)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1, embed_dim))
        for i, dp in enumerate(drop_path_rates(depth)):
            self.add_module(f"blocks_{i}", ViTBlock(embed_dim, num_heads, 4.0, sdpa, dp))
        self.last_norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None):
        """drop_masks: (depth, 2, B) keep masks, or None (no stochastic depth)."""
        conv = self.patch_embed_proj
        x = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                     conv.stride, conv.padding)  # (B, D, Hp, Wp)
        B, D, Hp, Wp = x.shape
        if (Hp, Wp) != self.grid:
            raise ValueError(f"input gives a {Hp}x{Wp} token grid; the model was built for "
                             f"{self.grid[0]}x{self.grid[1]}")
        x = x.flatten(2).transpose(1, 2)  # (B, Hp * Wp, D), row-major over the grid
        pos = self.pos_embed.to(x.dtype)
        x = x + pos[:, 1:] + pos[:, :1]
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, None if drop_masks is None else drop_masks[i])
        return _layer_norm(x, self.last_norm).view(B, Hp, Wp, D)


class HeatmapHead(nn.Module):
    """Two [ConvTranspose k4 s2 p1, BatchNorm, ReLU] and a 1x1 conv, NHWC in and out.
    The BatchNorms run on their running statistics (in f32 when the weights are f32 and
    the activations not), or in training mode on the batch's (flax's rule,
    `models/batch_norm.py`)."""

    def __init__(self, in_channels: int, out_channels: int = 1, filters: int = 256):
        super().__init__()
        self.deconv_layers_0 = nn.ConvTranspose2d(in_channels, filters, 4, stride=2, padding=1,
                                                  bias=False)
        self.deconv_layers_1 = nn.BatchNorm2d(filters)
        self.deconv_layers_3 = nn.ConvTranspose2d(filters, filters, 4, stride=2, padding=1,
                                                  bias=False)
        self.deconv_layers_4 = nn.BatchNorm2d(filters)
        self.final_layer = nn.Conv2d(filters, out_channels, 1)

    def _deconv_bn_relu(self, x, deconv: nn.ConvTranspose2d, bn: nn.BatchNorm2d):
        x = F.conv_transpose2d(x, deconv.weight.to(x.dtype), None, stride=2, padding=1)
        if self.training or bn.weight.dtype != x.dtype:  # in f32, rounded to x.dtype
            return F.relu(batch_norm(x.permute(0, 2, 3, 1), bn).permute(0, 3, 1, 2))
        return F.relu(bn(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = self._deconv_bn_relu(x, self.deconv_layers_0, self.deconv_layers_1)
        x = self._deconv_bn_relu(x, self.deconv_layers_3, self.deconv_layers_4)
        conv = self.final_layer
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype)).permute(0, 2, 3, 1)


class VitPoseNet(nn.Module):
    """Ball (1 output, 3 frames) or table (13 outputs, 1 frame) detector at one resolution.

    Input (B, H, W, 3 * in_frames) with (W, H) = `resolution`; output
    (heatmap (B, H / 4, W / 4, out_channels), None), as the JAX model returns.
    train: build in training mode (stochastic depth, the head's batch statistics).
    """

    def __init__(self, out_channels: int = 1, in_frames: int = 3, model_size: str = "small",
                 resolution: Tuple[int, int] = (1152, 640), sdpa: bool = True,
                 train: bool = False):
        super().__init__()
        if model_size not in EMBED_DIMS:
            raise ValueError(f"unknown model_size {model_size!r}")
        dim = EMBED_DIMS[model_size]
        W, H = resolution
        self.model_backbone = ViTBackbone(patch_grid(H, W), dim, DEPTH, 12, 3 * in_frames, sdpa)
        self.model_keypoint_head = HeatmapHead(dim, out_channels, 256)
        self.train(train)

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None):
        """drop_masks (training mode only, and required there): (depth, 2, B) keep masks.
        Outside training mode they are ignored, as in JAX."""
        if self.training and drop_masks is None:
            raise ValueError("VitPoseNet in training mode needs drop_masks "
                             "(draw_drop_masks(generator, batch))")
        masks = drop_masks if self.training else None
        return self.model_keypoint_head(self.model_backbone(x, masks)), None
