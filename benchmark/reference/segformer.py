"""Plain SegFormer (MiT encoder and all-MLP head) in float32 PyTorch, as the paper describes
it (Xie et al., NeurIPS 2021), for judging the port's detectors.

Modules carry the names of the port's state dict, so one set of weights made by the
benchmark loads into both. Inputs and outputs are NCHW: (B, 3 * in_frames, H, W) ->
(B, out_channels, H / 4, W / 4). Departures from the paper, each that of the model the port
implements: the reduction conv pads its input up to a multiple of its stride, low side
first, as flax's "SAME" does (at the timed sizes every grid divides, so nothing is padded);
LayerNorm's epsilon is 1e-6 and BatchNorm's 1e-5 (the flax defaults). The head runs as
published: each stage projected to the decoder width, resized to the first stage's grid,
concatenated last stage first, fused by a 1x1 conv, BatchNorm (running statistics; in
training mode the batch's), ReLU, the 1x1 classifier.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.numerics import Products


def _ln(x, norm: nn.LayerNorm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                        norm.eps)


def batch_norm(x, bn: nn.BatchNorm2d):
    """BatchNorm, channels in dim 1: on its running statistics, or in training mode on the
    batch's mean and biased variance (the flax rule of the reference trainer), which it
    keeps as `bn.batch_stats`, with each image's mean and mean square as `bn.image_stats`."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if bn.training:
        dims = (0,) + tuple(range(2, x.ndim))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        bn.batch_stats = (mean.detach(), var.detach())
        bn.image_stats = (x.detach().mean(dims[1:]), (x.detach() ** 2).mean(dims[1:]))
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    scale = bn.weight.float() / torch.sqrt(var + bn.eps)
    return (x - mean.reshape(shape)) * scale.reshape(shape) + bn.bias.float().reshape(shape)


class Attention(nn.Module):
    def __init__(self, dim, heads, sr, ln_eps):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
            self.sr_norm = nn.LayerNorm(dim, eps=ln_eps)

    def forward(self, y, H, W, P: Products):
        B, N, C = y.shape
        hd = C // self.heads
        q = P.linear(y, self.q.weight, self.q.bias).reshape(B, N, self.heads, hd)
        kv_in = y
        if self.sr_ratio > 1:
            r = self.sr_ratio
            t = y.transpose(1, 2).reshape(B, C, H, W)
            ph, pw = -H % r, -W % r
            t = F.pad(t, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            t = P.conv2d(t, self.sr.weight, self.sr.bias, stride=r)
            kv_in = _ln(t.flatten(2).transpose(1, 2), self.sr_norm)
        kv = P.linear(kv_in, self.kv.weight, self.kv.bias).reshape(B, -1, 2, self.heads, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        logits = P.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        o = P.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v).reshape(B, N, C)
        return P.linear(o, self.proj.weight, self.proj.bias)


class MixFFN(nn.Module):
    def __init__(self, dim, ratio):
        super().__init__()
        hid = dim * ratio
        self.fc1 = nn.Linear(dim, hid)
        self.dwconv = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.fc2 = nn.Linear(hid, dim)

    def forward(self, y, H, W, P: Products):
        B, N, _ = y.shape
        h = P.linear(y, self.fc1.weight, self.fc1.bias)
        hid = h.shape[-1]
        h = h.transpose(1, 2).reshape(B, hid, H, W)
        h = P.conv2d(h, self.dwconv.weight, self.dwconv.bias, padding=1, groups=hid)
        h = F.gelu(h, approximate="none").flatten(2).transpose(1, 2)
        return P.linear(h, self.fc2.weight, self.fc2.bias)


class Block(nn.Module):
    def __init__(self, dim, heads, sr, mlp_ratio, ln_eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, heads, sr, ln_eps)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x, H, W, P):
        x = P.act(x + self.attn(_ln(x, self.norm1), H, W, P))
        return P.act(x + self.ffn(_ln(x, self.norm2), H, W, P))


class Backbone(nn.Module):
    def __init__(self, cfg, in_chans):
        super().__init__()
        self.depths = cfg["depths"]
        prev = in_chans
        for s, dim in enumerate(cfg["dims"]):
            k, st, p = (7, 4, 3) if s == 0 else (3, 2, 1)
            self.add_module(f"patch_embed_{s}", nn.Conv2d(prev, dim, k, stride=st, padding=p))
            self.add_module(f"patch_norm_{s}", nn.LayerNorm(dim, eps=cfg["ln_eps"]))
            for b in range(cfg["depths"][s]):
                self.add_module(f"stage{s}_block{b}",
                                Block(dim, cfg["heads"][s], cfg["sr_ratios"][s],
                                      cfg["mlp_ratio"], cfg["ln_eps"]))
            self.add_module(f"stage_norm_{s}", nn.LayerNorm(dim, eps=cfg["ln_eps"]))
            prev = dim

    def forward(self, x, P):
        feats = []
        for s, depth in enumerate(self.depths):
            pe = getattr(self, f"patch_embed_{s}")
            x = P.conv2d(x, pe.weight, pe.bias, stride=pe.stride, padding=pe.padding)
            B, C, H, W = x.shape
            t = P.act(_ln(x.flatten(2).transpose(1, 2), getattr(self, f"patch_norm_{s}")))
            for b in range(depth):
                t = getattr(self, f"stage{s}_block{b}")(t, H, W, P)
            t = P.act(_ln(t, getattr(self, f"stage_norm_{s}")))
            x = t.transpose(1, 2).reshape(B, C, H, W)
            feats.append(x)
        return feats


class Head(nn.Module):
    def __init__(self, in_dims, out_channels, D, bn_eps):
        super().__init__()
        self.n = len(in_dims)
        for i, c in enumerate(in_dims):
            self.add_module(f"linear_c{i}", nn.Linear(c, D))
        self.linear_fuse = nn.Conv2d(D * self.n, D, 1, bias=False)
        self.fuse_bn = nn.BatchNorm2d(D, eps=bn_eps)
        self.conv_seg = nn.Conv2d(D, out_channels, 1)

    def forward(self, feats, P):
        size = feats[0].shape[2:]
        outs = []
        for i, f in enumerate(feats):
            lin = getattr(self, f"linear_c{i}")
            t = P.linear(f.flatten(2).transpose(1, 2), lin.weight, lin.bias)
            t = t.transpose(1, 2).reshape(f.shape[0], -1, *f.shape[2:])
            if i > 0:
                t = F.interpolate(t, size=size, mode="bilinear", align_corners=False)
            outs.append(t)
        x = P.conv2d(torch.cat(outs[::-1], dim=1), self.linear_fuse.weight)
        x = torch.relu(batch_norm(x, self.fuse_bn))
        return P.conv2d(x, self.conv_seg.weight, self.conv_seg.bias)


class SegFormer(nn.Module):
    """forward(x (B, 3 * in_frames, H, W), P) -> heatmaps (B, out_channels, H/4, W/4)."""

    def __init__(self, cfg, in_frames, out_channels):
        super().__init__()
        self.backbone = Backbone(cfg, 3 * in_frames)
        self.decode_head = Head(cfg["dims"], out_channels, cfg["decoder_dim"], cfg["bn_eps"])

    def forward(self, x, P: Products):
        return self.decode_head(self.backbone(x, P), P)
