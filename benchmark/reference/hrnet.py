"""Plain HRNet (WASB's w18-small graph: full-resolution stem, strides (1, 1)) in float32
PyTorch, for judging the port's WASB ball detector and its table HRNet.

Each convolution is followed by its BatchNorm on the running statistics, then the
residual and the ReLU, as the published graph runs them (no folding). Modules carry the
names of the port's state dict. NCHW: (B, 3 * in_frames, H, W) -> (B, out_channels, H, W).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.numerics import Products
from benchmark.reference.segformer import batch_norm


def _conv(cin, cout, k, stride=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class _Net(nn.Module):
    """Shared helpers: a conv with the BatchNorm its name pairs with (convN -> bnN, X_0 ->
    X_1), the residual and the ReLU."""

    def cbr(self, P: Products, name, x, relu=False, residual=None):
        conv = getattr(self, name)
        y = P.conv2d(x, conv.weight, conv.bias, stride=conv.stride, padding=conv.padding)
        partner = ("bn" + name[4:]) if name.startswith("conv") else \
            (name[:-2] + "_1" if name.endswith("_0") else None)
        bn = getattr(self, partner, None) if partner else None
        if isinstance(bn, nn.BatchNorm2d):
            y = batch_norm(y, bn)
        if residual is not None:
            y = y + residual
        return P.act(torch.relu(y) if relu else y)


class BasicBlock(_Net):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        self.has_downsample = has_downsample
        self.conv1, self.bn1 = _conv(inplanes, planes, 3, stride), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), nn.BatchNorm2d(planes)
        if has_downsample:
            self.downsample_0 = _conv(inplanes, planes, 1, stride)
            self.downsample_1 = nn.BatchNorm2d(planes)

    def forward(self, x, P):
        y = self.cbr(P, "conv1", x, relu=True)
        res = self.cbr(P, "downsample_0", x) if self.has_downsample else x
        return self.cbr(P, "conv2", y, relu=True, residual=res)


class Bottleneck(_Net):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, has_downsample=False):
        super().__init__()
        out = planes * 4
        self.has_downsample = has_downsample
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), nn.BatchNorm2d(out)
        if has_downsample:
            self.downsample_0 = _conv(inplanes, out, 1, stride)
            self.downsample_1 = nn.BatchNorm2d(out)

    def forward(self, x, P):
        y = self.cbr(P, "conv1", x, relu=True)
        y = self.cbr(P, "conv2", y, relu=True)
        res = self.cbr(P, "downsample_0", x) if self.has_downsample else x
        return self.cbr(P, "conv3", y, relu=True, residual=res)


def _up(x, f):
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


class HRModule(_Net):
    def __init__(self, n, block, num_blocks, in_ch, num_channels):
        super().__init__()
        blk = BasicBlock if block == "BASIC" else Bottleneck
        out = [c * blk.expansion for c in num_channels]
        self.n, self.num_blocks = n, tuple(num_blocks)
        for i in range(n):
            inplanes = in_ch[i]
            for b in range(num_blocks[i]):
                self.add_module(f"branches_{i}_{b}",
                                blk(inplanes, num_channels[i], 1, b == 0 and in_ch[i] != out[i]))
                inplanes = out[i]
        if n == 1:
            return
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse_layers_{i}_{j}_0", _conv(out[j], out[i], 1))
                    self.add_module(f"fuse_layers_{i}_{j}_1", nn.BatchNorm2d(out[i]))
                elif j < i:
                    for k in range(i - j):
                        ch = out[i] if k == i - j - 1 else out[j]
                        self.add_module(f"fuse_layers_{i}_{j}_{k}_0", _conv(out[j], ch, 3, 2))
                        self.add_module(f"fuse_layers_{i}_{j}_{k}_1", nn.BatchNorm2d(ch))

    def forward(self, xs, P: Products):
        ys = []
        for i in range(self.n):
            y = xs[i]
            for b in range(self.num_blocks[i]):
                y = getattr(self, f"branches_{i}_{b}")(y, P)
            ys.append(y)
        if self.n == 1:
            return ys
        fused = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = _up(self.cbr(P, f"fuse_layers_{i}_{j}_0", ys[j]), 2 ** (j - i))
                else:
                    t = ys[j]
                    for k in range(i - j):
                        t = self.cbr(P, f"fuse_layers_{i}_{j}_{k}_0", t, relu=k < i - j - 1)
                acc = t if acc is None else acc + t
            fused.append(P.act(torch.relu(acc)))
        return fused


class HRNet(_Net):
    def __init__(self, cfg, in_frames, out_channels):
        super().__init__()
        self.cfg = cfg
        stem, (s0, s1) = cfg["stem_inplanes"], cfg["stem_strides"]
        self.conv1, self.bn1 = _conv(3 * in_frames, stem, 3, s0), nn.BatchNorm2d(stem)
        self.conv2, self.bn2 = _conv(stem, stem, 3, s1), nn.BatchNorm2d(stem)
        s1cfg = cfg["stage1"]
        blk = Bottleneck if s1cfg["block"] == "BOTTLENECK" else BasicBlock
        planes, inplanes = s1cfg["num_channels"][0], stem
        for b in range(s1cfg["num_blocks"][0]):
            self.add_module(f"layer1_{b}",
                            blk(inplanes, planes, 1, b == 0 and inplanes != planes * blk.expansion))
            inplanes = planes * blk.expansion
        prev = [inplanes]
        self.plans = []
        for si in (2, 3, 4):
            scfg = cfg[f"stage{si}"]
            exp = 1 if scfg["block"] == "BASIC" else 4
            cur = [c * exp for c in scfg["num_channels"]]
            plan = []
            for i in range(len(cur)):
                if i < len(prev):
                    if cur[i] != prev[i]:
                        self.add_module(f"transition{si - 1}_{i}_0", _conv(prev[i], cur[i], 3))
                        self.add_module(f"transition{si - 1}_{i}_1", nn.BatchNorm2d(cur[i]))
                        plan.append(("conv", 1))
                    else:
                        plan.append(("keep", 0))
                else:
                    n = i + 1 - len(prev)
                    for j in range(n):
                        oc = cur[i] if j == n - 1 else prev[-1]
                        self.add_module(f"transition{si - 1}_{i}_{j}_0", _conv(prev[-1], oc, 3, 2))
                        self.add_module(f"transition{si - 1}_{i}_{j}_1", nn.BatchNorm2d(oc))
                    plan.append(("new", n))
            self.plans.append(plan)
            self.add_module(f"stage{si}_0", HRModule(len(cur), scfg["block"], scfg["num_blocks"],
                                                     cur, scfg["num_channels"]))
            prev = cur
        self.final_layers_0 = _conv(prev[0], out_channels, cfg["final_conv_kernel"], bias=True)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eps = cfg["bn_eps"]

    def forward(self, x, P):
        y = self.cbr(P, "conv1", x, relu=True)
        y = self.cbr(P, "conv2", y, relu=True)
        for b in range(self.cfg["stage1"]["num_blocks"][0]):
            y = getattr(self, f"layer1_{b}")(y, P)
        ys = [y]
        for si, plan in zip((2, 3, 4), self.plans):
            xs = []
            for i, (kind, n) in enumerate(plan):
                if kind == "keep":
                    xs.append(ys[i])
                elif kind == "conv":
                    xs.append(self.cbr(P, f"transition{si - 1}_{i}_0", ys[i], relu=True))
                else:
                    t = ys[-1]
                    for j in range(n):
                        t = self.cbr(P, f"transition{si - 1}_{i}_{j}_0", t, relu=True)
                    xs.append(t)
            ys = getattr(self, f"stage{si}_0")(xs, P)
        return self.cbr(P, "final_layers_0", ys[0])


class Wrapped(nn.Module):
    """The detector's state-dict prefix `model.` around the HRNet."""

    def __init__(self, cfg, in_frames, out_channels):
        super().__init__()
        self.model = HRNet(cfg, in_frames, out_channels)

    def forward(self, x, P):
        return self.model(x, P)
