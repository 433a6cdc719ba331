"""K4: depthwise 3x3 convolution, SAME zero padding, stride 1, + bias, NHWC.

Port of `upliftingtabletennis_tpu/ops/dwconv.py` (`depthwise_conv3x3` and its
custom VJP `_dw_fwd` / `_dw_bwd`). The function is

    out[b, h, w, c] = bias[c] + sum_{i, j} x[b, h + i - 1, w + j - 1, c] * k[i, j, c]

with x zero outside the image. The SegFormer trainer runs it in the backward of
every MiTBlock's FFN half, where K2's recompute (`ops/fused_ffn.py:ln_ffn_ref`)
calls it: once for the recomputed hidden tensor and once for that call's dx.

`depthwise_conv3x3` is differentiable. Its forward dispatches on the tensor's
device: CUDA tensors go to the hand-written Hopper kernel (`csrc/dwconv.cu`, which
replaces `_dw_kernel`; bound by device memory, 4 bytes per element), CPU tensors
to `dwconv3x3_plain`. Its backward is `_dw_bwd`'s: dx is the same function of the
cotangent with the spatially flipped kernel and no bias (K4 again on the card),
dw[i, j, c] = sum g * xpad[:, i:i+H, j:j+W, c] and db = sum g, as plain torch
reductions in f32 (the JAX package leaves those to XLA too). A build or launch
failure raises; nothing falls back to the plain version on CUDA.

Layout: x (B, H, W, C); k (3, 3, C), the JAX (3, 3, 1, C) with the 1 dropped, as
K2 takes it; bias (C,).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["depthwise_conv3x3", "dwconv3x3_plain"]

_SOURCE = "dwconv.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int


def _acc_dtype(dtype):
    """f32 sums for f32 and narrower inputs, f64 for f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def dwconv3x3_plain(x, w, bias):
    """Plain PyTorch version of K4: a grouped conv2d with f32 sums, output in x.dtype."""
    C = x.shape[-1]
    acc = _acc_dtype(x.dtype)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(2, 0, 1).unsqueeze(1),
                 bias.to(acc), padding=1, groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_dwconv3x3
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


def _launch(x, w, bias):
    B, H, W, C = x.shape
    if C % 8:
        raise ValueError(f"depthwise_conv3x3: the kernel needs C % 8 == 0; got C={C}")
    args = [_build.operand(x, "x", (B, H, W, C)), _build.operand(w, "w", (3, 3, C)),
            _build.operand(bias, "bias", (C,))]
    if any(a.device != x.device for a in args):
        raise ValueError("depthwise_conv3x3: all operands must be on x's device")
    out = torch.empty_like(args[0])
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_dwconv3x3(*[a.data_ptr() for a in args], out.data_ptr(),
                                    B, H, W, C, stream)
    _build.check(lib, status, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1
    return out


def _forward(x, w, bias):
    if _build.uses_kernel(x, "depthwise_conv3x3"):
        return _launch(x, w, bias)
    return dwconv3x3_plain(x, w, bias)


def _dx_taps(w):
    """The taps of dx's conv: the kernel flipped in both spatial axes."""
    return w.flip((0, 1))


class _DepthwiseConv3x3(torch.autograd.Function):
    """K4 forward; `_dw_bwd`'s backward."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g = g.contiguous()
        dx = dw = db = None
        if need_x:
            zero = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
            dx = _forward(g.to(x.dtype), _dx_taps(w).to(x.dtype), zero)
        acc = _acc_dtype(x.dtype)
        if need_w:
            B, H, W, _ = x.shape
            gf = g.to(acc)
            xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
            dw = torch.stack([torch.stack([(gf * xp[:, i:i + H, j:j + W]).sum((0, 1, 2))
                                           for j in range(3)]) for i in range(3)]).to(w.dtype)
        if need_b:
            db = g.to(acc).sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def depthwise_conv3x3(x, w, bias):
    """SAME depthwise 3x3 conv + bias: x (B, H, W, C), w (3, 3, C), bias (C,) -> x's shape
    and dtype. Differentiable; the kernel takes bf16 and C % 8 == 0, any H and W."""
    C = x.shape[-1]
    if x.ndim != 4 or tuple(w.shape) != (3, 3, C) or tuple(bias.shape) != (C,):
        raise ValueError(f"depthwise_conv3x3: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if _build.needs_grad(x, w, bias):
        return _DepthwiseConv3x3.apply(x, w, bias)
    return _forward(x, w, bias)


depthwise_conv3x3.launches = 0
