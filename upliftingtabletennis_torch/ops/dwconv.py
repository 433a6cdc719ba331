"""K4: depthwise 3x3 convolution, SAME zero padding, stride 1, + bias, NHWC.

Port of `upliftingtabletennis_tpu/ops/dwconv.py` (`depthwise_conv3x3` and its
custom VJP `_dw_fwd` / `_dw_bwd`). The function is

    out[b, h, w, c] = bias[c] + sum_{i, j} x[b, h + i - 1, w + j - 1, c] * k[i, j, c]

with x zero outside the image. The SegFormer trainer runs it in the backward of
every MiTBlock's FFN half, where K2's recompute (`ops/fused_ffn.py:ln_ffn_ref`)
calls it, and then its backward.

`depthwise_conv3x3` is differentiable. Its forward dispatches on the tensor's
device: CUDA tensors go to the hand-written Hopper kernel (`csrc/dwconv.cu`, which
replaces `_dw_kernel`; bound by device memory, 4 bytes per element), CPU tensors
to `dwconv3x3_plain`. Its backward computes `_dw_bwd`'s dx (the same conv of the
cotangent with the spatially flipped kernel and no bias), dw[i, j, c] = sum g *
xpad[:, i:i+H, j:j+W, c] and db = sum g: on CUDA in one pass of the backward kernel
(`dwconv3x3_backward`: dx, and per-block f32 partial sums of dw and db that a second
launch sums in a fixed order, so two calls give bit-identical dw and db), on the CPU
by `dwconv3x3_backward_plain`. Both kernels walk `dwconv_plan`'s tiles. A build or
launch failure raises; nothing falls back to the plain version on CUDA.

Layout: x (B, H, W, C); k (3, 3, C), the JAX (3, 3, 1, C) with the 1 dropped, as
K2 takes it; bias (C,).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["depthwise_conv3x3", "dwconv3x3_plain", "dwconv3x3_backward",
           "dwconv3x3_backward_plain", "dwconv_plan"]

_SOURCE = "dwconv.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int

# The tiles of csrc/dwconv.cu, which checks every plan it is given against its own: output
# columns per tile, channels per tile of the forward and of the backward, dw's 9 taps and db
# per channel.
TILE_W = 8
TILE_C = {False: 64, True: 32}
PARTS = 10
# The plan's rows per tile: tall enough that the two halo rows cost little, and few
# enough tiles per image that the grid holds about TARGET_BLOCKS blocks (8 per SM of
# the H100's 132: two waves or more at the 4-5 blocks an SM holds), at least MIN_ROWS.
TARGET_BLOCKS = 8 * 132
MIN_ROWS = 8


class DwPlan(NamedTuple):
    rows: int      # output rows per tile
    tiles_w: int
    tiles_h: int
    groups: int    # channel groups
    partials: int  # the backward's per-block partial sums: B * tiles_h * tiles_w (0 forward)


def dwconv_plan(B: int, H: int, W: int, C: int, backward: bool = False) -> DwPlan:
    """The tiles of the forward (or backward) kernel for x (B, H, W, C): TILE_W columns
    by TILE_C channels by `rows` rows, one block each, per sample."""
    tiles_w, groups = -(-W // TILE_W), -(-C // TILE_C[backward])
    per_row_of_tiles = B * tiles_w * groups
    n_h = max(1, -(-TARGET_BLOCKS // per_row_of_tiles))
    rows = min(H, max(MIN_ROWS, -(-H // n_h)))
    tiles_h = -(-H // rows)
    return DwPlan(rows, tiles_w, tiles_h, groups, B * tiles_h * tiles_w if backward else 0)


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


def dwconv3x3_backward_plain(x, w, g):
    """Plain PyTorch version of K4's backward (the JAX `_dw_bwd`): (dx, dw, db) of
    `depthwise_conv3x3(x, w, bias)` for the cotangent g, with f32 sums. dx is the conv
    of g with the flipped taps and no bias, in x.dtype; dw[i, j, c] = sum g *
    xpad[:, i:i+H, j:j+W, c] in w.dtype; db = sum g in f32 (f64 for f64 inputs)."""
    B, H, W, C = x.shape
    zero = torch.zeros(C, dtype=x.dtype, device=x.device)
    dx = dwconv3x3_plain(g.to(x.dtype), w.flip((0, 1)).to(x.dtype), zero)
    gf = g.to(_acc_dtype(x.dtype))
    xp = F.pad(x.to(gf.dtype), (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.stack([(gf * xp[:, i:i + H, j:j + W]).sum((0, 1, 2))
                                   for j in range(3)]) for i in range(3)])
    return dx, dw.to(w.dtype), gf.sum((0, 1, 2))


def _lib():
    lib = _build.library(_SOURCE)
    if lib.uttk_dwconv3x3.argtypes is None:
        lib.uttk_dwconv3x3.argtypes = [_P] * 4 + [_I] * 8 + [_P]
        lib.uttk_dwconv3x3.restype = _I
        lib.uttk_dwconv3x3_backward.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        lib.uttk_dwconv3x3_backward.restype = _I
    return lib


def _operands(x, w, *rest):
    """x's shape checked for the kernel, and the operands as the kernel takes them."""
    B, H, W, C = x.shape
    if C % 8:
        raise ValueError(f"depthwise_conv3x3: the kernel needs C % 8 == 0; got C={C}")
    args = [_build.operand(x, "x", (B, H, W, C)), _build.operand(w, "w", (3, 3, C))]
    args += [_build.operand(t, name, shape) for t, name, shape in rest]
    if any(a.device != x.device for a in args):
        raise ValueError("depthwise_conv3x3: all operands must be on x's device")
    return args


def _launch(x, w, bias):
    B, H, W, C = x.shape
    args = _operands(x, w, (bias, "bias", (C,)))
    out = torch.empty_like(args[0])
    if out.numel() == 0:
        return out
    lib, plan = _lib(), dwconv_plan(B, H, W, C)
    status = _build.call_on_device(x, lambda stream: lib.uttk_dwconv3x3(
        *[a.data_ptr() for a in args], out.data_ptr(), B, H, W, C, *plan[:4], stream))
    _build.check(lib, status, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1
    return out


def _launch_backward(x, taps, g):
    B, H, W, C = x.shape
    xk, tk, gk = _operands(x, taps, (g, "g", (B, H, W, C)))
    dx = torch.empty_like(xk)
    if dx.numel() == 0:
        sums = torch.zeros(PARTS, C, dtype=torch.float32, device=x.device)
        return dx, sums[:9].view(3, 3, C), sums[9]
    sums = torch.empty(PARTS, C, dtype=torch.float32, device=x.device)
    lib, plan = _lib(), dwconv_plan(B, H, W, C, backward=True)
    partial = torch.empty(plan.partials, PARTS, C, dtype=torch.float32, device=x.device)
    status = _build.call_on_device(x, lambda stream: lib.uttk_dwconv3x3_backward(
        gk.data_ptr(), xk.data_ptr(), tk.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        sums.data_ptr(), B, H, W, C, *plan, stream))
    _build.check(lib, status, "dwconv3x3_backward")
    dwconv3x3_backward.launches += 2  # the fused pass and the sum of its partials
    return dx, sums[:9].view(3, 3, C), sums[9]


def _forward(x, w, bias):
    if _build.uses_kernel(x, "depthwise_conv3x3"):
        return _launch(x, w, bias)
    return dwconv3x3_plain(x, w, bias)


def _dx_taps(w):
    """The taps of dx's conv: the kernel flipped in both spatial axes."""
    return w.flip((0, 1))


def dwconv3x3_backward(x, w, g):
    """(dx, dw, db) of `depthwise_conv3x3(x, w, bias)` for the cotangent g (x's shape):
    dx in x.dtype, dw in w.dtype, db in f32 (f64 for f64 inputs on the CPU). CUDA tensors
    go to the backward kernel (bf16 operands; two launches, the fused pass and the sum of
    its partials, each counted in `launches`), CPU tensors to `dwconv3x3_backward_plain`."""
    if not _build.uses_kernel(x, "dwconv3x3_backward"):
        return dwconv3x3_backward_plain(x, w, g)
    dx, dw, db = _launch_backward(x, _dx_taps(w).to(x.dtype), g.to(x.dtype))
    return dx, dw.to(w.dtype), db


class _DepthwiseConv3x3(torch.autograd.Function):
    """K4 forward; `_dw_bwd`'s backward (the backward kernel on the card)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx, dw, db = dwconv3x3_backward(x, w, g.contiguous())
        return (dx if need_x else None, dw if need_w else None,
                db.to(ctx.bias_dtype) if need_b else None)


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
dwconv3x3_backward.launches = 0
