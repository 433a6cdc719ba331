"""The 2D -> 3D uplifting transformer in torch.

Port of `upliftingtabletennis_tpu/models/uplifting.py`. Modules are named after the
flax tree (`firststage.table_stage.pos_layers_0.attn.qkv`, `secondstage_3.mlp1.fc2`,
`cls_token`, ...), so `utils/convert.py:flax_to_torch` carries a JAX parameter tree
across by a path walk.

* RoPE over timestamps on q and k (`ops/attention.py`); one fused `qkv` projection with
  a bias, an output projection `proj` without one.
* Pre-LN blocks (LayerNorm epsilon 1e-6, as flax) with a ReLU MLP of ratio 1.
* 'dynamic' table tokens: per timestep, the ball token attends to the 13 embedded
  table keypoints, invisible ones masked, fake times arange(13) / (MAX_FPS / 5).
* Variants 'singlestage', 'multistage' and 'connectstage'; sizes small (32, 8, 4 heads),
  base (64, 12, 4), large (128, 16, 4) and huge (192, 16, 8).

The model runs in f32 (about 2 M parameters at batch 1 for 'large').
"""
from __future__ import annotations

import math

import torch
from torch import nn

from upliftingtabletennis_torch.core.geometry import (KEYPOINT_VISIBLE, MAX_FPS,
                                                      NUM_TABLE_KEYPOINTS)
from upliftingtabletennis_torch.ops.attention import (NEG_INF, apply_rope_over_time,
                                                      masked_attention)

__all__ = ["Mlp2", "Head3", "RopeAttention", "TransformerLayer", "FirstStage",
           "SingleStageModel", "MultiStageModel", "get_uplifting_model", "reference_init"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class Mlp2(nn.Module):
    """Linear, ReLU, Linear; hidden width = dim."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class Head3(nn.Module):
    """Regression head dim -> dim/2 -> dim/4 -> 3."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim // 2)
        self.fc2 = nn.Linear(dim // 2, dim // 4)
        self.fc3 = nn.Linear(dim // 4, 3)

    def forward(self, x):
        return self.fc3(torch.relu(self.fc2(torch.relu(self.fc1(x)))))


class RopeAttention(nn.Module):
    """Multi-head attention with RoPE over time on q and k and the symmetric additive mask."""

    def __init__(self, dim: int, num_heads: int, time_rotation: str = "new"):
        super().__init__()
        self.dim, self.num_heads, self.time_rotation = dim, num_heads, time_rotation
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim, bias=False)

    def _rope(self, t, times, num_cls_token):
        if num_cls_token == 0:
            return apply_rope_over_time(t, times, self.time_rotation)
        return torch.cat([t[..., :num_cls_token, :],
                          apply_rope_over_time(t[..., num_cls_token:, :], times,
                                               self.time_rotation)], dim=-2)

    def forward(self, x, mask_add, times, num_cls_token: int = 0):
        """x (..., N, D); mask_add (..., N); times (..., N - num_cls_token)."""
        h, d = self.num_heads, self.dim
        qkv = self.qkv(x).reshape(*x.shape[:-1], 3, h, d // h)
        q, k, v = torch.movedim(qkv, (-3, -2), (0, -3))  # 3 x (..., H, N, Dh)
        q = self._rope(q, times, num_cls_token)
        k = self._rope(k, times, num_cls_token)
        out = masked_attention(q, k, v, mask_add)
        return self.proj(torch.movedim(out, -3, -2).reshape(*x.shape[:-1], d))


class TransformerLayer(nn.Module):
    """x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, time_rotation: str = "new"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = RopeAttention(dim, num_heads, time_rotation)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp1 = Mlp2(dim, dim)

    def forward(self, x, mask_add, times, num_cls_token: int = 0):
        x = x + self.attn(self.norm1(x), mask_add, times, num_cls_token)
        return x + self.mlp1(self.norm2(x))


def _layers(module: nn.Module, prefix: str, n: int, dim: int, heads: int, time_rotation: str):
    """n TransformerLayers registered as `prefix_0` ... (the flax names)."""
    names = [f"{prefix}_{i}" for i in range(n)]
    for name in names:
        module.add_module(name, TransformerLayer(dim, heads, time_rotation))
    return names


class _TableTokenStage(nn.Module):
    """Per timestep, attention of the ball token (no RoPE) against the 13 table tokens."""

    def __init__(self, dim: int, num_heads: int, time_rotation: str = "new", depth: int = 4):
        super().__init__()
        self.table_embed = Mlp2(2, dim)
        self._names = _layers(self, "pos_layers", depth, dim, num_heads, time_rotation)

    def forward(self, x, table_img):
        """x (B, T, D) ball tokens; table_img (B, 13, 3), visibility last. -> (B, T, D)."""
        B, T, D = x.shape
        N = table_img.shape[-2]
        table_mask = torch.where(table_img[..., 2] == KEYPOINT_VISIBLE, 0.0, NEG_INF).to(x.dtype)
        mask_add = torch.cat([torch.zeros_like(table_mask[:, :1]), table_mask], dim=1)[:, None]
        table_times = (torch.arange(N, dtype=x.dtype, device=x.device)
                       / (MAX_FPS / 5)).expand(B, 1, N)
        table_tok = self.table_embed(table_img[..., :2])[:, None].expand(B, T, N, D)
        tokens = torch.cat([x[:, :, None, :], table_tok], dim=2)  # (B, T, N+1, D)
        for name in self._names:
            tokens = getattr(self, name)(tokens, mask_add, table_times, num_cls_token=1)
        return tokens[:, :, 0, :]


def _ball_input(ball_img, table_img, mode):
    """The ball embedding's input: positions, with the flat table for 'stacked' (x, y, v)
    and 'originalmethod' (x, y)."""
    B, T, _ = ball_img.shape
    if mode == "stacked":
        flat = table_img.reshape(B, 1, -1).expand(B, T, NUM_TABLE_KEYPOINTS * 3)
    elif mode == "originalmethod":
        flat = table_img[..., :2].reshape(B, 1, -1).expand(B, T, NUM_TABLE_KEYPOINTS * 2)
    else:
        return ball_img
    return torch.cat([ball_img, flat], dim=-1)


_IN_DIM = {"stacked": 2 + 3 * NUM_TABLE_KEYPOINTS, "originalmethod": 2 + 2 * NUM_TABLE_KEYPOINTS}


def _mask_add(mask, dtype):
    return torch.where(mask > 0.5, 0.0, NEG_INF).to(dtype)


class FirstStage(nn.Module):
    """The position-predicting stage."""

    def __init__(self, dim, depth, num_heads, mode="dynamic", time_rotation="new"):
        super().__init__()
        self.mode = mode
        self.ball_embed = Mlp2(_IN_DIM.get(mode, 2), dim)
        if mode == "dynamic":
            self.table_stage = _TableTokenStage(dim, num_heads, time_rotation)
        self._names = _layers(self, "layers", depth, dim, num_heads, time_rotation)
        self.position_head = Head3(dim)

    def forward(self, ball_img, table_img, mask_add, times):
        x = self.ball_embed(_ball_input(ball_img, table_img, self.mode))
        if self.mode == "dynamic":
            x = self.table_stage(x, table_img)
        for name in self._names:
            x = getattr(self, name)(x, mask_add, times)
        return self.position_head(x), x


class SingleStageModel(nn.Module):
    """A cls token and joint rotation / position heads."""

    def __init__(self, dim, depth, num_heads, mode="dynamic", time_rotation="new"):
        super().__init__()
        self.mode, self.dim = mode, dim
        self.ball_embed = Mlp2(_IN_DIM.get(mode, 2), dim)
        if mode == "dynamic":
            self.table_stage = _TableTokenStage(dim, num_heads, time_rotation)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self._names = _layers(self, "layers", depth, dim, num_heads, time_rotation)
        self.rotation_head = Head3(dim)
        self.position_head = Head3(dim)

    def forward(self, ball_img, table_img, mask, times):
        B = ball_img.shape[0]
        mask_add = _mask_add(mask, ball_img.dtype)
        x = self.ball_embed(_ball_input(ball_img, table_img, self.mode))
        if self.mode == "dynamic":
            x = self.table_stage(x, table_img)
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], dim=1)
        mask_add = torch.cat([torch.zeros_like(mask_add[:, :1]), mask_add], dim=1)
        for name in self._names:
            x = getattr(self, name)(x, mask_add, times, num_cls_token=1)
        return self.rotation_head(x[:, 0]), self.position_head(x[:, 1:])


class MultiStageModel(nn.Module):
    """FirstStage positions, then a second stage that predicts the spin from them
    (use_skipconnection: from the first stage's tokens, the 'connectstage' variant)."""

    def __init__(self, dim, depth, num_heads, mode="dynamic", time_rotation="new",
                 use_skipconnection=True, full_backprop=False, depth_secondstage=4):
        super().__init__()
        self.dim, self.use_skipconnection = dim, use_skipconnection
        self.full_backprop = full_backprop
        self.firststage = FirstStage(dim, depth - depth_secondstage, num_heads, mode,
                                     time_rotation)
        if not use_skipconnection:
            self.embed = Mlp2(3, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self._names = _layers(self, "secondstage", depth_secondstage, dim, num_heads,
                              time_rotation)
        self.rotation_head = Head3(dim)

    def forward(self, ball_img, table_img, mask, times):
        B = ball_img.shape[0]
        mask_add = _mask_add(mask, ball_img.dtype)
        pos, pos_token = self.firststage(ball_img, table_img, mask_add, times)
        x = pos_token if self.use_skipconnection else pos
        if not self.full_backprop:  # the spin's gradient must not reach the positions
            x = x.detach()
        if not self.use_skipconnection:
            x = self.embed(x)
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], dim=1)
        mask_add2 = torch.cat([torch.zeros_like(mask_add[:, :1]), mask_add], dim=1)
        for name in self._names:
            x = getattr(self, name)(x, mask_add2, times, num_cls_token=1)
        return self.rotation_head(x[:, 0]), pos


_SIZES = {"small": (32, 8, 4), "base": (64, 12, 4), "large": (128, 16, 4), "huge": (192, 16, 8)}


def get_uplifting_model(name: str = "connectstage", size: str = "large", mode: str = "dynamic",
                        time_rotation: str = "new", full_backprop: bool = False) -> nn.Module:
    """The model factory; the defaults are the paper's configuration."""
    if time_rotation not in ("old", "new"):
        raise ValueError("time_rotation must be 'old' or 'new'")
    if size not in _SIZES:
        raise ValueError(f"unknown size {size!r}")
    dim, depth, heads = _SIZES[size]
    if name == "singlestage":
        if mode not in ("free", "dynamic", "stacked"):
            raise ValueError(f"mode {mode!r} invalid for singlestage")
        return SingleStageModel(dim, depth, heads, mode, time_rotation)
    if name in ("multistage", "connectstage"):
        if mode not in ("dynamic", "stacked", "originalmethod"):
            raise ValueError(f"mode {mode!r} invalid for {name}")
        return MultiStageModel(dim, depth, heads, mode, time_rotation,
                               use_skipconnection=(name == "connectstage"),
                               full_backprop=full_backprop)
    raise ValueError(f"unknown model name {name!r}")


def reference_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX model's initialisation, drawn from `generator` (on the CPU): every kernel
    xavier-uniform, U(-g sqrt(6 / (fan_in + fan_out)), +...), with the gains of the
    reference (1.414 before a ReLU: Mlp2.fc1, Head3.fc1 and fc2; 1 elsewhere), biases 0,
    LayerNorms 1 and 0, the cls token xavier-uniform over fans (1, dim) as flax counts
    them for a (1, 1, dim) array. The trainer starts from it; inference without a
    checkpoint uses `pipeline.interface.init_weights`."""
    def xavier(w, gain, fan_in, fan_out):
        limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * limit)

    def linear(layer, gain):
        xavier(layer.weight, gain, layer.in_features, layer.out_features)
        if layer.bias is not None:
            layer.bias.zero_()

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Mlp2):
                linear(m.fc1, 1.414)
                linear(m.fc2, 1.0)
            elif isinstance(m, Head3):
                linear(m.fc1, 1.414)
                linear(m.fc2, 1.414)
                linear(m.fc3, 1.0)
            elif isinstance(m, RopeAttention):
                linear(m.qkv, 1.0)
                linear(m.proj, 1.0)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if isinstance(getattr(model, "cls_token", None), nn.Parameter):
            xavier(model.cls_token, 1.0, 1, model.cls_token.shape[-1])
    return model
