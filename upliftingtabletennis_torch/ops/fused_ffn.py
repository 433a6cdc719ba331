"""K2: fused LayerNorm + MixFFN + residual (the SegFormer FFN half-block).

Port of `upliftingtabletennis_tpu/ops/fused_ffn.py` (`fused_ln_ffn`, the
v1 kernel; v2/v3 compute the same function in TPU lane layouts). The
function is

    out = x + fc2(gelu_erf(dw3x3(fc1(LN(x))) + bdw)) + b2

with the depthwise conv zero-padding the hidden tensor at the image border.

`fused_ln_ffn` dispatches on the tensor's device: CUDA tensors go to the
hand-written Hopper kernel (`csrc/fused_ffn.cu`), CPU tensors to
`ln_ffn_plain`, the plain PyTorch version the tests hold against the JAX
kernel. A build or launch failure raises; nothing falls back on CUDA.

It is differentiable: when autograd would record the call, it runs through
`fused_ln_ffn_trainable`, the counterpart of the JAX custom VJP of the same
name. Its forward is the kernel and saves only the inputs; its backward
recomputes `ln_ffn_ref` (the JAX `_ref_ln_ffn`, with its casts) and returns
that graph's gradients, so the (N, 4C) hidden tensor is never stored. The
recompute's depthwise conv is K4 (`ops/dwconv.py`), as on the TPU.

Weights use the JAX layout at this interface: w1 (C, HID), dw (3, 3, HID),
w2 (HID, C). The kernel reads w1/w2 as the torch Linear layout (out, in)
and the depthwise taps as (9, HID).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops.dwconv import depthwise_conv3x3

__all__ = ["fused_ln_ffn", "fused_ln_ffn_trainable", "ln_ffn_plain", "ln_ffn_ref"]

_SOURCE = "fused_ffn.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def ln_ffn_plain(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2, eps=1e-6):
    """Plain PyTorch version of K2, with the kernel's casts.

    x (B, H*W, C); w1 (C, HID), b1 (HID,); dw (3, 3, HID), bdw (HID,);
    w2 (HID, C), b2 (C,). LN and the products accumulate in f32; LN(x),
    the hidden tensor and the GELU output round to x.dtype where the
    kernel rounds them (no-ops in f32).
    """
    B, N, C = x.shape
    HID = w1.shape[1]
    dt = x.dtype
    xf = x.float()
    y = F.layer_norm(xf, (C,), gamma.float(), beta.float(), eps).to(dt)
    h = (y.float() @ w1.float() + b1.float()).to(dt)
    h = h.float().reshape(B, H, W, HID).permute(0, 3, 1, 2)
    h = F.conv2d(h, dw.float().permute(2, 0, 1).unsqueeze(1), bdw.float(), padding=1,
                 groups=HID)
    z = F.gelu(h, approximate="none").permute(0, 2, 3, 1).reshape(B, N, HID).to(dt)
    return (xf + z.float() @ w2.float() + b2.float()).to(dt)


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_fused_ffn
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 5 + [_F, _P]
        fn.restype = _I
        lib.uttk_fused_ffn_tile.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
        lib.uttk_fused_ffn_tile.restype = _I
    return lib


def kernel_tile(C: int):
    """(rows, cols) of the output tile the CUDA kernel uses at width C (one
    instantiation per SegFormer width: 32, 64, 128, 160, 256, 320, 512)."""
    th, tw = _I(0), _I(0)
    if not _lib().uttk_fused_ffn_tile(C, ctypes.byref(th), ctypes.byref(tw)):
        raise ValueError(f"fused_ln_ffn: the kernel has no instantiation for C={C}")
    return th.value, tw.value


def _launch(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2, eps):
    B, N, C = x.shape
    HID = w1.shape[1]
    if HID % 64:
        raise ValueError(f"kernel needs HID % 64 == 0; got HID={HID}")
    kernel_tile(C)  # raises for a width the kernel is not instantiated for
    args = [
        _build.operand(x, "x", (B, N, C)),
        _build.operand(gamma, "gamma", (C,)), _build.operand(beta, "beta", (C,)),
        _build.operand(w1.t(), "w1", (HID, C)), _build.operand(b1, "b1", (HID,)),
        _build.operand(dw.reshape(9, HID), "dw", (9, HID)), _build.operand(bdw, "bdw", (HID,)),
        _build.operand(w2.t(), "w2", (C, HID)), _build.operand(b2, "b2", (C,)),
    ]
    if any(a.device != x.device for a in args):
        raise ValueError("fused_ln_ffn: all operands must be on x's device")
    out = torch.empty_like(args[0])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_fused_ffn(*[a.data_ptr() for a in args], out.data_ptr(),
                                    B, H, W, C, HID, float(eps), stream)
    _build.check(lib, status, "fused_ln_ffn")
    fused_ln_ffn.launches += 1
    return out


def ln_ffn_ref(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2, eps=1e-6):
    """The JAX `_ref_ln_ffn` (ops/fused_ffn.py:447), with its casts: LN in f32 rounded
    to x.dtype, the products, GELU and the residual in x.dtype, and the depthwise conv
    through `depthwise_conv3x3` (K4 on the card). The backward of
    `fused_ln_ffn_trainable` recomputes this."""
    B, N, C = x.shape
    HID = w1.shape[1]
    dt = x.dtype
    y = F.layer_norm(x.float(), (C,), gamma.float(), beta.float(), eps).to(dt)
    h = (y @ w1.to(dt) + b1.to(dt)).reshape(B, H, W, HID)
    h = depthwise_conv3x3(h, dw.to(dt), bdw.to(dt)).reshape(B, N, HID)
    z = F.gelu(h, approximate="none")
    return x + (z @ w2.to(dt) + b2.to(dt))


class _FusedLnFfn(torch.autograd.Function):
    """K2 forward, recompute backward (the JAX `_fused_ln_ffn_fwd` / `_fused_ln_ffn_bwd`)."""

    @staticmethod
    def forward(ctx, x, H, W, eps, *params):
        ctx.save_for_backward(x, *params)
        ctx.shape = (H, W, eps)
        return fused_ln_ffn(x, H, W, *params, eps=eps)

    @staticmethod
    def backward(ctx, g):
        H, W, eps = ctx.shape
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:1] +
                                     ctx.needs_input_grad[4:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ln_ffn_ref(inputs[0], H, W, *inputs[1:], eps=eps)
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        dx, *dparams = [next(grads) if t.requires_grad else None for t in inputs]
        return (dx, None, None, None, *dparams)


def fused_ln_ffn_trainable(x, H: int, W: int, gamma, beta, w1, b1, dw, bdw, w2, b2,
                           eps: float = 1e-6):
    """`fused_ln_ffn` as an autograd Function: K2's forward, saving only the inputs, and
    a backward that recomputes `ln_ffn_ref` (port of the JAX `fused_ln_ffn_trainable`)."""
    return _FusedLnFfn.apply(x, H, W, eps, gamma, beta, w1, b1, dw, bdw, w2, b2)


def fused_ln_ffn(x, H: int, W: int, gamma, beta, w1, b1, dw, bdw, w2, b2, eps: float = 1e-6):
    """out = x + fc2(gelu(dw3x3(fc1(LN(x))))) for x (B, N, C), N == H*W. Any H, W.
    Differentiable (through `fused_ln_ffn_trainable`)."""
    N = x.shape[1]
    if N != H * W:
        raise ValueError(f"N={N} != H*W={H}*{W}")
    params = (gamma, beta, w1, b1, dw, bdw, w2, b2)
    if _build.needs_grad(x, *params):
        return fused_ln_ffn_trainable(x, H, W, *params, eps=eps)
    if _build.uses_kernel(x, "fused_ln_ffn"):
        return _launch(x, H, W, *params, eps)
    return ln_ffn_plain(x, H, W, *params, eps)


fused_ln_ffn.launches = 0
