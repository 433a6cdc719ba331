"""K5: fused convolution + bias + ReLU (+ residual), stride 1 (the HRNet convs).

Port of `upliftingtabletennis_tpu/ops/fused_conv.py`: `conv3x3_bias_act`
(K5a, kernel `_k3`) and `conv1x1_bias_act` (K5b, kernel `_k1`). The function is

    out = act(conv_same(x, w) + b [+ residual])

with x and the residual NHWC, f32 accumulation and one rounding of the
output to x.dtype. `act` is ReLU or the identity, b may be None.

Both wrappers dispatch on the tensor's device: CUDA tensors go to the
hand-written Hopper kernel (`csrc/fused_conv.cu`), CPU tensors to the plain
PyTorch versions `conv3x3_bias_act_plain` / `conv1x1_bias_act_plain`, which
the tests hold against the JAX kernels. A build or launch failure raises;
nothing falls back on CUDA.

The kernels have no backward yet (it comes with the HRNet trainer): on CUDA
a call that autograd would record raises, rather than return an output with
no gradient. On the CPU the plain versions are differentiable.

Weights use the JAX layout at this interface: (3, 3, Ci, Co) and (Ci, Co).
The kernel reads them as `pack(w, b)` lays them out: (round16(Co),
round16(taps * Ci)) bf16 with column (dy * 3 + dx) * Ci + ci, zero-padded,
and an f32 bias. A caller that runs the same conv many times (the HRNet)
packs once and passes the `Packed` operands in place of `w` and `b`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["conv3x3_bias_act", "conv1x1_bias_act", "conv3x3_bias_act_plain",
           "conv1x1_bias_act_plain", "pack", "unpack", "Packed"]

_SOURCE = "fused_conv.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_NO_INSTANTIATION = -1  # uttk_fused_conv: no kernel for this (ks, Ci, Co)


def _finish(y, b, residual, relu, dtype):
    if b is not None:
        y = y + b.float()
    if residual is not None:
        y = y + residual.float()
    return (torch.relu(y) if relu else y).to(dtype)


def conv3x3_bias_act_plain(x, w, b=None, residual=None, *, relu=True):
    """Plain PyTorch version of K5a: x (B, H, W, Ci), w (3, 3, Ci, Co), b (Co,) or None,
    residual (B, H, W, Co) or None. Sums in f32, one rounding to x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return _finish(y.permute(0, 2, 3, 1), b, residual, relu, x.dtype).contiguous()


def conv1x1_bias_act_plain(x, w, b=None, residual=None, *, relu=True):
    """Plain PyTorch version of K5b: x (B, H, W, Ci), w (Ci, Co)."""
    return _finish(x.float() @ w.float(), b, residual, relu, x.dtype)


class Packed(NamedTuple):
    """A conv's kernel operands: the weight in the kernel's layout, the f32 bias, and
    the conv's kernel size and channels."""
    weight: torch.Tensor
    bias: Optional[torch.Tensor]
    ks: int
    ci: int
    co: int


def pack(w: torch.Tensor, b: Optional[torch.Tensor] = None) -> Packed:
    """(3, 3, Ci, Co) or (Ci, Co) weight, (Co,) bias -> the kernel's operands."""
    w4 = w if w.ndim == 4 else w[None, None]
    ks, _, ci, co = w4.shape
    k = ks * ks * ci
    wk = w4.permute(3, 0, 1, 2).reshape(co, k)
    wk = F.pad(wk, (0, -k % 16, 0, -co % 16)).to(torch.bfloat16).contiguous()
    return Packed(wk, None if b is None else b.float().contiguous(), ks, ci, co)


def unpack(p: Packed):
    """The (3, 3, Ci, Co) or (Ci, Co) weight (bf16) and the bias of packed operands."""
    k = p.ks * p.ks * p.ci
    w = p.weight[:p.co, :k].reshape(p.co, p.ks, p.ks, p.ci).permute(1, 2, 3, 0)
    return (w if p.ks == 3 else w[0, 0]), p.bias


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_fused_conv
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def _launch(wrapper, x, p: Packed, residual, relu):
    name = wrapper.__name__
    B, H, W, Ci = x.shape
    x = _build.operand(x, "x", (B, H, W, Ci))
    k = p.ks * p.ks * Ci
    wk = _build.operand(p.weight, "packed weight", (p.co + -p.co % 16, k + -k % 16))
    ptrs = [x, wk]
    bias = p.bias
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (p.co,):
            raise ValueError(f"{name}: packed bias must be float32 of shape ({p.co},)")
        bias = bias.contiguous()
        ptrs.append(bias)
    if residual is not None:
        residual = _build.operand(residual, "residual", (B, H, W, p.co))
        ptrs.append(residual)
    if any(t.device != x.device for t in ptrs):
        raise ValueError(f"{name}: all operands must be on x's device")
    out = torch.empty((B, H, W, p.co), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_fused_conv(x.data_ptr(), wk.data_ptr(),
                                     None if bias is None else bias.data_ptr(),
                                     None if residual is None else residual.data_ptr(),
                                     out.data_ptr(), B, H, W, p.ks, Ci, p.co, int(relu), stream)
    if status == _NO_INSTANTIATION:
        raise ValueError(f"{name}: the kernel has no instantiation for Ci={Ci}, Co={p.co}")
    _build.check(lib, status, name)
    wrapper.launches += 1
    return out


def _run(wrapper, ks, x, w, b, residual, relu):
    """Check the weight against x; then the plain version on CPU, the kernel on CUDA."""
    name, ci = wrapper.__name__, x.shape[-1]
    packed = w if isinstance(w, Packed) else None
    if packed is not None:
        if b is not None:
            raise ValueError(f"{name}: packed operands carry their bias; b must be None")
        fits = (packed.ks, packed.ci) == (ks, ci)
        what = f"packed for ks={packed.ks}, Ci={packed.ci}"
    else:
        fits = tuple(w.shape[:-1]) == ((3, 3, ci) if ks == 3 else (ci,))
        what = tuple(w.shape)
    if not fits:
        raise ValueError(f"{name}: weight {what} for Ci={ci}")
    if not _build.uses_kernel(x, name):
        if packed is not None:
            w, b = unpack(packed)
        plain = conv3x3_bias_act_plain if ks == 3 else conv1x1_bias_act_plain
        return plain(x, w, b, residual, relu=relu)
    operands = (x, residual, *((packed.weight, packed.bias) if packed is not None else (w, b)))
    if _build.needs_grad(*operands):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward yet (the HRNet trainer, "
                           f"ROADMAP queue 1 item 8); call it under torch.no_grad()")
    return _launch(wrapper, x, pack(w, b) if packed is None else packed, residual, relu)


def conv3x3_bias_act(x, w, b=None, residual=None, *, relu=True):
    """act(conv3x3_same(x, w) + b [+ residual]), stride 1. x (B, H, W, Ci), any H, W;
    w (3, 3, Ci, Co) with b, or `pack(w, b)` with b None."""
    return _run(conv3x3_bias_act, 3, x, w, b, residual, relu)


def conv1x1_bias_act(x, w, b=None, residual=None, *, relu=True):
    """act(x @ w + b [+ residual]). x (B, H, W, Ci); w (Ci, Co) with b, or `pack(w, b)`."""
    return _run(conv1x1_bias_act, 1, x, w, b, residual, relu)


conv3x3_bias_act.launches = 0
conv1x1_bias_act.launches = 0
