"""HRNet detectors (WASB ball, HRNet table) in PyTorch, with a folded inference path.

Port of `upliftingtabletennis_tpu/models/hrnet.py` (the graph: WASB
w18-small configuration, full-resolution stem with strides (1, 1)) and of the
function of `models/hrnet_packed.py` (BatchNorm folded into the convs, the
residual and ReLU in the second conv's epilogue), without its TPU lane
packing. Modules are named after the flax tree (`model.conv1`, `bn1`,
`layer1_0`, `transition1_0_0`, `stage2_0.branches_0_0`,
`fuse_layers_0_1_0`, `final_layers_0`, ...), so
`utils/convert.py:flax_to_torch` is a path walk and a converted checkpoint
loads with `strict=True`. Inputs and outputs are NHWC like the JAX model.

In eval mode (the default) BatchNorm runs on its running statistics (eps 1e-5, the
flax default). The weights stay f32. The first forward folds every BatchNorm into
its conv, in f32, then casts to the input's dtype (as `hrnet_packed._P.conv_bn`
does) and, on the kernel path on CUDA, keeps only the kernel's packed
operands; it folds again when the device or dtype of its input changes,
`load_state_dict` brings new weights, or the model leaves training mode
(`train(False)`: an optimizer step changes the weights in place). Each conv then
runs as:

* stride-1 3x3 -> K5a `conv3x3_bias_act`, stride-1 1x1 -> K5b
  `conv1x1_bias_act` (`ops/fused_conv.py`): bias, ReLU and the residual of a
  BasicBlock's second conv (or a Bottleneck's conv3, with the downsample
  branch's output as the residual) in the kernel's epilogue;
* stride-2 3x3 (new-branch transitions, fuse down-chains) -> `F.conv2d` with
  the folded bias, as the JAX package computes them outside any Pallas kernel;
* the fuse sums, their ReLU and the nearest-neighbour upsampling -> tensor ops.

One forward launches K5a 40 times and K5b 14 times; 18 convs are stride 2.

In training mode (`train=True` or `.train()`) the graph is the JAX model's with
`train=True`: each conv unfolded (`F.conv2d`, cuDNN on the card; K5 has no backward
and raises under grad), then BatchNorm on the batch's statistics by flax's rule
(`models/batch_norm.py`: biased variance, running statistics at momentum 0.9), then
the residual and ReLU. `remat=True` checkpoints each BasicBlock and Bottleneck
(`torch.utils.checkpoint`, non-reentrant), as the JAX model's `nn.remat` does; the
blocks hand their batch statistics out, and the running statistics move once, after
the forward, so the recompute in the backward cannot move them again. On the card the
trainers run the forward in bf16 (the convolutions and the activations), with the
BatchNorm statistics and the loss in f32 and the parameters and Adam in f32, the
convention of the SegFormer trainer.

`kernels=False` builds the same graph with the plain versions of K5 (for
comparisons on the card).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from upliftingtabletennis_torch.models.batch_norm import Stats, batch_norm, update_running_stats
from upliftingtabletennis_torch.ops.fused_conv import (Packed, conv1x1_bias_act,
                                                      conv1x1_bias_act_plain, conv3x3_bias_act,
                                                      conv3x3_bias_act_plain, pack)

BN_EPS = 1e-5  # flax nn.BatchNorm default

# WASB w18-small configuration (ref: models/hrnet.py:152-161 of the JAX package)
WASB_CFG: Dict[str, Any] = {
    "stem_inplanes": 64,
    "stem_strides": (1, 1),
    "stage1": {"block": "BOTTLENECK", "num_blocks": (1,), "num_channels": (32,)},
    "stage2": {"block": "BASIC", "num_blocks": (2, 2), "num_channels": (16, 32)},
    "stage3": {"block": "BASIC", "num_blocks": (2, 2, 2), "num_channels": (16, 32, 64)},
    "stage4": {"block": "BASIC", "num_blocks": (2, 2, 2, 2), "num_channels": (16, 32, 64, 128)},
    "final_conv_kernel": 1,
}


def fold_bn(kernel, scale, bias, mean, var, eps=BN_EPS):
    """Fold inference BatchNorm into the preceding conv's HWIO `kernel`: returns (w, b).

    The port's copy of `fold_bn` in the JAX package's `models/hrnet_packed.py`."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s, bias - mean * s


class Folded(NamedTuple):
    """A conv with its BatchNorm folded in, ready to run."""
    # stride 1: (3, 3, Ci, Co) or (Ci, Co), or the kernel's operands with the bias
    # (CUDA, kernels=True); stride 2: OIHW
    weight: Union[torch.Tensor, Packed]
    bias: Optional[torch.Tensor]
    stride: int
    ks: int


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def _bn_of(parent: nn.Module, name: str) -> Optional[nn.BatchNorm2d]:
    """The BatchNorm after conv `name`: convN -> bnN, X_0 -> X_1 (flax naming)."""
    if name.startswith("conv"):
        partner = "bn" + name[4:]
    elif name.endswith("_0"):
        partner = name[:-2] + "_1"
    else:
        return None
    bn = getattr(parent, partner, None)
    return bn if isinstance(bn, nn.BatchNorm2d) else None


class _Runner:
    """Runs folded convs, through the K5 kernels or their plain versions."""

    def __init__(self, kernels: bool):
        self.k3 = conv3x3_bias_act if kernels else conv3x3_bias_act_plain
        self.k1 = conv1x1_bias_act if kernels else conv1x1_bias_act_plain

    def block(self, blk: nn.Module, x):
        return blk(x, self)

    def __call__(self, conv: nn.Conv2d, x, relu: bool = False, residual=None):
        f: Folded = conv.folded
        if f.stride == 1:
            fn = self.k3 if f.ks == 3 else self.k1
            return fn(x, f.weight, f.bias, residual, relu=relu)
        y = F.conv2d(x.permute(0, 3, 1, 2), f.weight, f.bias, stride=f.stride,
                     padding=f.weight.shape[-1] // 2).permute(0, 2, 3, 1)
        return torch.relu(y) if relu else y


class _TrainRunner:
    """Runs unfolded convs in training mode: F.conv2d, flax's BatchNorm on the batch's
    statistics (collected in `stats`, applied by the caller), the residual, ReLU.
    remat: each block under `torch.utils.checkpoint`."""

    def __init__(self, remat: bool):
        self.remat = remat
        self.stats: Stats = []

    def block(self, blk: nn.Module, x):
        if not self.remat:
            return blk(x, self)
        bns = []

        def body(t):
            sub = _TrainRunner(False)
            y = blk(t, sub)
            if not bns:  # the recompute in the backward finds them recorded
                bns.extend(bn for bn, _, _ in sub.stats)
            return y, [s for _, mean, var in sub.stats for s in (mean, var)]

        y, flat = checkpoint(body, x, use_reentrant=False)
        self.stats += [(bn, flat[2 * i], flat[2 * i + 1]) for i, bn in enumerate(bns)]
        return y

    def __call__(self, conv: nn.Conv2d, x, relu: bool = False, residual=None):
        bn = conv.bn_partner
        y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                     None if conv.bias is None else conv.bias.to(x.dtype),
                     stride=conv.stride, padding=conv.padding).permute(0, 2, 3, 1)
        if bn is not None:
            y = batch_norm(y, bn, self.stats)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.has_downsample = has_downsample
        self.conv1, self.bn1 = _conv(inplanes, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        if has_downsample:
            self.downsample_0, self.downsample_1 = _conv(inplanes, planes, 1, stride), _bn(planes)

    def forward(self, x, run: _Runner):
        y = run(self.conv1, x, relu=True)
        res = run(self.downsample_0, x) if self.has_downsample else x
        return run(self.conv2, y, relu=True, residual=res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.has_downsample = has_downsample
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), _bn(out)
        if has_downsample:
            self.downsample_0, self.downsample_1 = _conv(inplanes, out, 1, stride), _bn(out)

    def forward(self, x, run: _Runner):
        y = run(self.conv1, x, relu=True)
        y = run(self.conv2, y, relu=True)
        res = run(self.downsample_0, x) if self.has_downsample else x
        return run(self.conv3, y, relu=True, residual=res)


def _upsample_nearest(x, factor: int):
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


class HighResolutionModule(nn.Module):
    """Parallel branches + full cross-resolution fusion (ref: models/hrnet.py:94-149)."""

    def __init__(self, num_branches: int, block: str, num_blocks, num_inchannels, num_channels):
        super().__init__()
        blk = BasicBlock if block == "BASIC" else Bottleneck
        out_ch = [c * blk.expansion for c in num_channels]
        self.num_branches, self.num_blocks = num_branches, tuple(num_blocks)
        for i in range(num_branches):
            inplanes = num_inchannels[i]
            for b in range(num_blocks[i]):
                has_ds = b == 0 and num_inchannels[i] != out_ch[i]
                self.add_module(f"branches_{i}_{b}", blk(inplanes, num_channels[i], 1, has_ds))
                inplanes = out_ch[i]
        if num_branches == 1:
            return
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse_layers_{i}_{j}_0", _conv(out_ch[j], out_ch[i], 1))
                    self.add_module(f"fuse_layers_{i}_{j}_1", _bn(out_ch[i]))
                elif j < i:
                    for k in range(i - j):
                        ch = out_ch[i] if k == i - j - 1 else out_ch[j]
                        self.add_module(f"fuse_layers_{i}_{j}_{k}_0", _conv(out_ch[j], ch, 3, 2))
                        self.add_module(f"fuse_layers_{i}_{j}_{k}_1", _bn(ch))

    def forward(self, xs, run: _Runner):
        ys = []
        for i in range(self.num_branches):
            y = xs[i]
            for b in range(self.num_blocks[i]):
                y = run.block(getattr(self, f"branches_{i}_{b}"), y)
            ys.append(y)
        if self.num_branches == 1:
            return ys
        fused = []
        for i in range(self.num_branches):
            acc = None
            for j in range(self.num_branches):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = run(getattr(self, f"fuse_layers_{i}_{j}_0"), ys[j])
                    t = _upsample_nearest(t, 2 ** (j - i))
                else:
                    t = ys[j]
                    for k in range(i - j):
                        t = run(getattr(self, f"fuse_layers_{i}_{j}_{k}_0"), t,
                                relu=k < i - j - 1)
                acc = t if acc is None else acc + t
            fused.append(torch.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet backbone + final conv (ref: models/hrnet.py:164-238 of the JAX package).

    forward(x (B, H, W, 3 * in_frames)) -> (heatmaps (B, H', W', out_channels), branch
    features); H' = H with the stem strides (1, 1)."""

    def __init__(self, out_channels: int = 3, in_frames: int = 1, cfg=None, kernels: bool = True,
                 remat: bool = False):
        super().__init__()
        cfg = cfg or WASB_CFG
        self.cfg, self.kernels, self.remat = cfg, kernels, remat
        stem, (s0, s1) = cfg["stem_inplanes"], cfg["stem_strides"]
        self.conv1, self.bn1 = _conv(3 * in_frames, stem, 3, s0), _bn(stem)
        self.conv2, self.bn2 = _conv(stem, stem, 3, s1), _bn(stem)

        s1cfg = cfg["stage1"]
        blk = Bottleneck if s1cfg["block"] == "BOTTLENECK" else BasicBlock
        planes, inplanes = s1cfg["num_channels"][0], stem
        for b in range(s1cfg["num_blocks"][0]):
            has_ds = b == 0 and inplanes != planes * blk.expansion
            self.add_module(f"layer1_{b}", blk(inplanes, planes, 1, has_ds))
            inplanes = planes * blk.expansion
        prev = [inplanes]
        self.stage_branches = []  # per stage: ("keep" | "conv" | "new", chain length)
        for si in (2, 3, 4):
            scfg = cfg[f"stage{si}"]
            exp = 1 if scfg["block"] == "BASIC" else 4
            cur = [c * exp for c in scfg["num_channels"]]
            plan = []
            for i in range(len(cur)):
                if i < len(prev):
                    if cur[i] != prev[i]:
                        self.add_module(f"transition{si - 1}_{i}_0", _conv(prev[i], cur[i], 3))
                        self.add_module(f"transition{si - 1}_{i}_1", _bn(cur[i]))
                        plan.append(("conv", 1))
                    else:
                        plan.append(("keep", 0))
                else:
                    n = i + 1 - len(prev)
                    for j in range(n):
                        out_c = cur[i] if j == n - 1 else prev[-1]
                        self.add_module(f"transition{si - 1}_{i}_{j}_0",
                                        _conv(prev[-1], out_c, 3, 2))
                        self.add_module(f"transition{si - 1}_{i}_{j}_1", _bn(out_c))
                    plan.append(("new", n))
            self.stage_branches.append(plan)
            self.add_module(f"stage{si}_0", HighResolutionModule(
                len(cur), scfg["block"], scfg["num_blocks"], cur, scfg["num_channels"]))
            prev = cur
        k = cfg["final_conv_kernel"]
        self.final_layers_0 = _conv(prev[0], out_channels, k, bias=True)
        for parent in self.modules():  # each conv's BatchNorm, outside the module tree
            for name, conv in parent.named_children():
                if isinstance(conv, nn.Conv2d):
                    object.__setattr__(conv, "bn_partner", _bn_of(parent, name))
        self._folded_key = None
        self.register_load_state_dict_post_hook(HRNet._unfold)

    @staticmethod
    def _unfold(module, incompatible_keys):
        module._folded_key = None

    def train(self, mode: bool = True):
        """Switch the mode; leaving training mode drops the folded weights (an optimizer
        step changed the weights in place)."""
        if not mode:
            self._folded_key = None
        return super().train(mode)

    @torch.no_grad()
    def _fold(self, dtype: torch.dtype) -> None:
        """Fold every BatchNorm into its conv (in f32, then cast to `dtype`); on the
        kernel path on CUDA, pack the stride-1 convs' operands in place of w and b."""
        device = self.conv1.weight.device
        pack_ops = self.kernels and device.type == "cuda"
        for parent in self.modules():
            for name, conv in parent.named_children():
                if not isinstance(conv, nn.Conv2d):
                    continue
                w = conv.weight.float().permute(2, 3, 1, 0)  # HWIO, as the flax kernel
                bn = conv.bn_partner
                if bn is not None:
                    w, b = fold_bn(w, bn.weight.float(), bn.bias.float(),
                                   bn.running_mean.float(), bn.running_var.float(), bn.eps)
                else:
                    b = None if conv.bias is None else conv.bias.float()
                w = w.to(dtype)
                b = None if b is None else b.to(dtype)
                stride, ks = conv.stride[0], conv.kernel_size[0]
                if stride == 1:
                    w = (w if ks == 3 else w[0, 0]).contiguous()
                    if pack_ops:
                        w, b = pack(w, b), None
                else:
                    w = w.permute(3, 2, 0, 1).contiguous()
                conv.folded = Folded(w, b, stride, ks)
        self._folded_key = (device, dtype)

    def forward(self, x):
        if self.training:
            run = _TrainRunner(self.remat)
            out = self._graph(x, run)
            for bn, mean, var in run.stats:
                update_running_stats(bn, mean, var)
            return out
        if self._folded_key != (x.device, x.dtype):
            self._fold(x.dtype)
        return self._graph(x, _Runner(self.kernels))

    def _graph(self, x, run):
        y = run(self.conv1, x, relu=True)
        y = run(self.conv2, y, relu=True)
        for b in range(self.cfg["stage1"]["num_blocks"][0]):
            y = run.block(getattr(self, f"layer1_{b}"), y)
        ys = [y]
        for si, plan in zip((2, 3, 4), self.stage_branches):
            xs = []
            for i, (kind, n) in enumerate(plan):
                if kind == "keep":
                    xs.append(ys[i])
                elif kind == "conv":
                    xs.append(run(getattr(self, f"transition{si - 1}_{i}_0"), ys[i], relu=True))
                else:
                    t = ys[-1]
                    for j in range(n):
                        t = run(getattr(self, f"transition{si - 1}_{i}_{j}_0"), t, relu=True)
                    xs.append(t)
            ys = getattr(self, f"stage{si}_0")(xs, run)
        return run(self.final_layers_0, ys[0]), ys


class WASBNet(nn.Module):
    """Ball detector: 3-frame input, the middle frame's heatmap channel
    (ref: models/hrnet.py:241-252)."""

    FOLDS_BATCH_NORM = True  # keep the weights f32: forward folds them into its dtype

    def __init__(self, in_frames: int = 3, kernels: bool = True, train: bool = False,
                 remat: bool = False):
        super().__init__()
        self.model = HRNet(3, in_frames, kernels=kernels, remat=remat)
        self.out_channels = 1
        self.train(train)

    def forward(self, x):
        heat, _ = self.model(x)
        return heat[..., 1:2], None


class TableHRNet(nn.Module):
    """Table-keypoint detector: one frame, 13 heatmap channels (ref: models/hrnet.py:254-266)."""

    FOLDS_BATCH_NORM = True

    def __init__(self, num_keypoints: int = 13, kernels: bool = True, train: bool = False,
                 remat: bool = False):
        super().__init__()
        self.model = HRNet(num_keypoints, 1, kernels=kernels, remat=remat)
        self.out_channels = num_keypoints
        self.train(train)

    def forward(self, x):
        return self.model(x)[0]
