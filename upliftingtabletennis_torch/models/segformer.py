"""SegFormer (MiT-b0/b2) heatmap detector in PyTorch.

Port of `upliftingtabletennis_tpu/models/segformer.py`. Modules are named
after the flax parameter tree (`backbone.stage0_block0.attn.q`,
`decode_head.linear_fuse`, ...), so `utils/convert.py:flax_to_torch` is a
path walk. Inputs and outputs are NHWC like the JAX model: input
(B, H, W, 3 * in_frames), heatmap (B, H/4, W/4, out_channels).

Every MiTBlock runs the two fused half-blocks: K1 (`ops/fused_attention.py`)
then K2 (`ops/fused_ffn.py`). The K/V side of the attention (sr-conv with
flax "SAME" padding, its LayerNorm, the kv projection) stays torch ops, as
it is XLA ops in the JAX model. `SegFormerNet(kernels=False)` calls the
plain PyTorch versions of the kernels on any device; it exists to compare
the whole model with and without the kernels on the card.

SegFormer++ token merging (`tome_ratio > 0`, the JAX model's unfused
attention branch): in every block, y = LN1(x) gives the ToMe plan
(`ops/token_merge.py`, where N >= 256), q is projected from the merged y,
K3 (`ops/flash_attention.py`) attends to the block's k and v, and the
output is projected, unmerged and added to x. The FFN half stays on K2, as
in the JAX block. `proj` runs on the merged tokens before the unmerge: a
per-token linear map commutes with the gather.

Training (`SegFormerNet(train=True)`, the flax `train` flag, which sets the
module's training mode): the decode head's BatchNorms normalise with the batch
statistics and update their running statistics as flax `BatchNorm(momentum=0.9)`
does. Every parameter is cast to the activation dtype where it is used, as the
JAX block casts with `.astype(dt)`, so an f32 model runs bf16 activations and its
gradients reach the f32 parameters through the casts. The kernel wrappers are
differentiable (recompute backwards, `ops/`), so the same forward trains.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from upliftingtabletennis_torch.models.batch_norm import batch_norm
from upliftingtabletennis_torch.ops.flash_attention import (cross_attention_plain,
                                                           flash_cross_attention)
from upliftingtabletennis_torch.ops.fused_attention import (attention_block_plain,
                                                           fused_attention_block)
from upliftingtabletennis_torch.ops.fused_ffn import fused_ln_ffn, ln_ffn_plain
from upliftingtabletennis_torch.ops.token_merge import (bipartite_soft_matching,
                                                       merge_tokens, unmerge_tokens)

# (ref: models/segformer.py:48-58 of the JAX package)
CFG = {
    "b0": {"dims": (32, 64, 160, 256), "depths": (2, 2, 2, 2), "decoder_dim": 256},
    "b1": {"dims": (64, 128, 320, 512), "depths": (2, 2, 2, 2), "decoder_dim": 256},
    "b2": {"dims": (64, 128, 320, 512), "depths": (3, 4, 6, 3), "decoder_dim": 768},
    "b3": {"dims": (64, 128, 320, 512), "depths": (3, 4, 18, 3), "decoder_dim": 768},
    "b4": {"dims": (64, 128, 320, 512), "depths": (3, 8, 27, 3), "decoder_dim": 768},
    "b5": {"dims": (64, 128, 320, 512), "depths": (3, 6, 40, 3), "decoder_dim": 768},
}
HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIOS = (4, 4, 4, 4)
LN_EPS = 1e-6  # flax nn.LayerNorm default
BN_EPS = 1e-5  # flax nn.BatchNorm default


def _linear(x, lin: nn.Linear):
    """nn.Linear with its parameters cast to x.dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _conv(x, conv: nn.Conv2d):
    """nn.Conv2d (NCHW) with its parameters cast to x.dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride, conv.padding)


def _layer_norm(x, norm: nn.LayerNorm):
    """LayerNorm in f32, rounded back to x.dtype (the JAX model's casts)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class EfficientAttention(nn.Module):
    """Parameters of the attention: q, kv, proj and (sr > 1) the sr-conv + LN.

    Without ToMe only the K/V side runs here (`kv_heads`); q, the attention
    and proj run inside K1 with these parameters. With ToMe, `merged` runs
    the rest of the attention around K3."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def kv_heads(self, y, H: int, W: int):
        """y = LN1(x) (B, N, C) -> k, v each (B, Nkv, heads, hd)."""
        B, N, C = y.shape
        kv_in = y
        if self.sr_ratio > 1:
            r = self.sr_ratio
            t = y.reshape(B, H, W, C).permute(0, 3, 1, 2)
            # flax "SAME" at kernel = stride = r: output ceil(H / r), the
            # padding split low = total // 2, high = the rest
            ph, pw = -H % r, -W % r
            t = F.pad(t, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            t = _conv(t, self.sr)
            kv_in = _layer_norm(t.flatten(2).transpose(1, 2), self.sr_norm)
        kv = _linear(kv_in, self.kv).reshape(B, -1, 2, self.num_heads, C // self.num_heads)
        return kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()

    def merged(self, y, k, v, tome_ratio: float, kernels: bool):
        """proj(attention(q(merge(y)), k, v)), unmerged: the attention branch of a
        ToMe block, (B, N, C). Merging starts at N >= 256, as in the JAX model."""
        B, N, C = y.shape
        plan = None
        if N >= 256:
            plan = bipartite_soft_matching(y, int(N * tome_ratio))
            y = merge_tokens(plan, y)
        q = _linear(y, self.q).reshape(B, y.shape[1], self.num_heads, C // self.num_heads)
        attend = flash_cross_attention if kernels else cross_attention_plain
        o = _linear(attend(q, k, v).reshape(B, -1, C), self.proj)
        return o if plan is None else unmerge_tokens(plan, o)


class MixFFN(nn.Module):
    """Parameters of the FFN: fc1, the depthwise 3x3 dwconv, fc2 (run inside K2)."""

    def __init__(self, dim: int, ratio: int):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int,
                 kernels: bool = True, tome_ratio: float = 0.0):
        super().__init__()
        self.kernels, self.tome_ratio = kernels, tome_ratio
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x, H: int, W: int):
        a, f = self.attn, self.ffn
        n1, n2 = self.norm1, self.norm2
        dt = x.dtype
        y = _layer_norm(x, n1)
        k, v = a.kv_heads(y, H, W)
        if self.tome_ratio > 0:
            x = x + a.merged(y, k, v, self.tome_ratio, self.kernels)
        else:
            attn = [n1.weight, n1.bias, a.q.weight.t(), a.q.bias, k, v, a.proj.weight.t(),
                    a.proj.bias]
            attn = [t.to(dt) for t in attn]
            if self.kernels:  # K1, differentiable (its recompute backward)
                x = fused_attention_block(x, H, W, a.num_heads, *attn, eps=n1.eps)
            else:
                x = attention_block_plain(x, a.num_heads, *attn, eps=n1.eps)
        dw = f.dwconv.weight[:, 0].permute(1, 2, 0)  # (HID, 1, 3, 3) -> (3, 3, HID)
        ffn = [n2.weight, n2.bias, f.fc1.weight.t(), f.fc1.bias, dw, f.dwconv.bias,
               f.fc2.weight.t(), f.fc2.bias]
        ffn = [t.to(dt) for t in ffn]
        if self.kernels:  # K2, differentiable (its recompute backward runs K4)
            return fused_ln_ffn(x, H, W, *ffn, eps=n2.eps)
        return ln_ffn_plain(x, H, W, *ffn, eps=n2.eps)


class MiTBackbone(nn.Module):
    """Mix Transformer encoder: 4 stages at 1/4, 1/8, 1/16, 1/32 scale."""

    def __init__(self, size: str = "b2", in_chans: int = 3, kernels: bool = True,
                 tome_ratio: float = 0.0):
        super().__init__()
        cfg = CFG[size]
        self.depths = cfg["depths"]
        prev = in_chans
        for s, dim in enumerate(cfg["dims"]):
            if s == 0:
                conv = nn.Conv2d(prev, dim, 7, stride=4, padding=3)
            else:
                conv = nn.Conv2d(prev, dim, 3, stride=2, padding=1)
            self.add_module(f"patch_embed_{s}", conv)
            self.add_module(f"patch_norm_{s}", nn.LayerNorm(dim, eps=LN_EPS))
            for b in range(cfg["depths"][s]):
                self.add_module(f"stage{s}_block{b}",
                                MiTBlock(dim, HEADS[s], SR_RATIOS[s], MLP_RATIOS[s], kernels,
                                         tome_ratio))
            self.add_module(f"stage_norm_{s}", nn.LayerNorm(dim, eps=LN_EPS))
            prev = dim

    def forward(self, x):
        """x (B, H, W, C_in) -> 4 NHWC feature maps."""
        feats = []
        t = x.permute(0, 3, 1, 2)
        for s, depth in enumerate(self.depths):
            t = _conv(t, getattr(self, f"patch_embed_{s}"))
            B, C, H, W = t.shape
            x = _layer_norm(t.flatten(2).transpose(1, 2), getattr(self, f"patch_norm_{s}"))
            x = x.contiguous()
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, H, W)
            x = _layer_norm(x, getattr(self, f"stage_norm_{s}"))
            feats.append(x.reshape(B, H, W, C))
            t = feats[-1].permute(0, 3, 1, 2)
        return feats


def _resize_bilinear(t, hw):
    """NHWC bilinear upsample (jax.image.resize 'bilinear' == half-pixel, clamped)."""
    y = F.interpolate(t.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class SegFormerHead(nn.Module):
    """All-MLP decode head with the JAX model's per-stage projection restructure.

    fuse(concat(resize(f_i Wc_i + bc_i))) = sum_i resize(f_i (Wc_i Wf_i)) + sum_i bc_i Wf_i,
    Wf_i the fuse kernel's row block of stage i (concat order reversed), so
    each stage is projected at its own resolution (ref: segformer.py:283-294).
    """

    def __init__(self, in_dims, out_channels: int, decoder_dim: int):
        super().__init__()
        D = decoder_dim
        self.n = len(in_dims)
        for i, c in enumerate(in_dims):
            self.add_module(f"linear_c{i}", nn.Linear(c, D))
        self.linear_fuse = nn.Conv2d(D * self.n, D, 1, bias=False)
        self.fuse_bn = nn.BatchNorm2d(D, eps=BN_EPS)
        self.conv_seg = nn.Conv2d(D, out_channels, 1)

    def forward(self, feats):
        D = self.linear_fuse.out_channels
        target_hw = feats[0].shape[1:3]
        dt = feats[0].dtype
        wf = self.linear_fuse.weight[:, :, 0, 0].t().to(dt)  # (n*D, D), the flax kernel
        acc = bias = None
        for i, f in enumerate(feats):
            lin = getattr(self, f"linear_c{i}")
            blk = wf[(self.n - 1 - i) * D:(self.n - i) * D]
            t = f @ (lin.weight.t().to(dt) @ blk)
            if i > 0:
                t = _resize_bilinear(t, target_hw)
            acc = t if acc is None else acc + t
            b = lin.bias.to(dt) @ blk
            bias = b if bias is None else bias + b
        x = torch.relu(batch_norm(acc + bias, self.fuse_bn))
        return x @ self.conv_seg.weight[:, :, 0, 0].t().to(dt) + self.conv_seg.bias.to(dt)


class MMSegHead(nn.Module):
    """mmseg-style SegformerHead (per-stage 1x1 conv + BN + ReLU, stage-order concat),
    used by ported reference segformerpp checkpoints; same resize/1x1 commute."""

    def __init__(self, in_dims, out_channels: int, decoder_dim: int):
        super().__init__()
        D = decoder_dim
        self.n = len(in_dims)
        for i, c in enumerate(in_dims):
            self.add_module(f"conv_{i}", nn.Conv2d(c, D, 1, bias=False))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(D, eps=BN_EPS))
        self.fusion_conv = nn.Conv2d(D * self.n, D, 1, bias=False)
        self.fusion_bn = nn.BatchNorm2d(D, eps=BN_EPS)
        self.conv_seg = nn.Conv2d(D, out_channels, 1)

    def forward(self, feats):
        D = self.fusion_conv.out_channels
        target_hw = feats[0].shape[1:3]
        dt = feats[0].dtype
        wf = self.fusion_conv.weight[:, :, 0, 0].t().to(dt)  # (n*D, D)
        acc = None
        for i, f in enumerate(feats):
            t = f @ getattr(self, f"conv_{i}").weight[:, :, 0, 0].t().to(dt)
            t = torch.relu(batch_norm(t, getattr(self, f"bn_{i}")))
            t = t @ wf[i * D:(i + 1) * D]
            if i > 0:
                t = _resize_bilinear(t, target_hw)
            acc = t if acc is None else acc + t
        x = torch.relu(batch_norm(acc, self.fusion_bn))
        return x @ self.conv_seg.weight[:, :, 0, 0].t().to(dt) + self.conv_seg.bias.to(dt)


class SegFormerNet(nn.Module):
    """Ball (out=1, in_frames=3) / table (out=13, in_frames=1) detector.

    forward(x (B, H, W, 3*in_frames)) -> (heatmap (B, H/4, W/4, out), cls logits or None).
    head_style "nvlabs" (the framework's own training) or "mmseg" (ported
    reference checkpoints). tome_ratio > 0: the share of query tokens ToMe
    merges in every attention (no parameters of its own). kernels=False runs
    the plain versions of the kernels (for comparisons only). train=True puts the
    module in training mode (the head's BatchNorms on batch statistics), as the
    flax model's `train` field does; `.train()` / `.eval()` switch it later.
    """

    def __init__(self, out_channels: int = 1, in_frames: int = 3, model_size: str = "b2",
                 classify_invisible: bool = False, tome_ratio: float = 0.0,
                 head_style: str = "nvlabs", decoder_dim: int = 0, kernels: bool = True,
                 train: bool = False):
        super().__init__()
        dims = CFG[model_size]["dims"]
        self.backbone = MiTBackbone(model_size, 3 * in_frames, kernels, tome_ratio)
        head_cls = {"nvlabs": SegFormerHead, "mmseg": MMSegHead}[head_style]
        self.decode_head = head_cls(dims, out_channels,
                                    decoder_dim or CFG[model_size]["decoder_dim"])
        self.visible_classification = nn.Linear(dims[-1], 2) if classify_invisible else None
        self.train(train)

    def forward(self, x):
        feats = self.backbone(x)
        heat = self.decode_head(feats)
        cls_out = None
        if self.visible_classification is not None:
            cls_out = _linear(feats[-1].mean(dim=(1, 2)), self.visible_classification)
        return heat, cls_out
