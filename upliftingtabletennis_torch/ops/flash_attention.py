"""K3: flash cross-attention, softmax(q kᵀ · scale) v, for many queries and few keys.

Port of `upliftingtabletennis_tpu/ops/flash_attention.py`. The SegFormer
block runs it when ToMe merges the queries (`models/segformer.py`): the
merged queries attend to the spatially reduced keys and values, which the
block has already projected.

`flash_cross_attention` dispatches on the tensor's device: CUDA tensors go
to the hand-written Hopper kernel (`csrc/flash_attention.cu`), CPU tensors
to `cross_attention_plain`, the plain PyTorch version of the same function
that the tests hold against the JAX kernel. A build or launch failure
raises; nothing falls back to the plain version on CUDA.

Layout: q (B, Nq, h, hd), k and v (B, Nkv, h, hd), as in the JAX function.
The kernel reads that layout directly (the JAX wrapper's transposes to
(B·h, N, hd) are a TPU layout).
"""
from __future__ import annotations

import ctypes

import torch

from upliftingtabletennis_torch.ops import _build

__all__ = ["flash_cross_attention", "cross_attention_plain"]

_SOURCE = "flash_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (32, 64)  # SegFormer b0 and b2


def cross_attention_plain(q, k, v, scale=None):
    """Plain PyTorch version of K3, with the kernel's casts: logits and softmax in
    f32, the weights rounded to v.dtype, f32 accumulation, the output in q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    return o.to(q.dtype)


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        fn.restype = _I
    return lib


def flash_cross_attention(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v per (sample, head); q (B, Nq, h, hd), k, v (B, Nkv, h, hd).

    scale defaults to hd ** -0.5. Returns (B, Nq, h, hd) in q's dtype.
    """
    B, Nq, heads, hd = q.shape
    Nkv = k.shape[1]
    if k.shape != (B, Nkv, heads, hd) or v.shape != k.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_cross_attention: no kernel for device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"the kernel takes bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or Nkv < 1:
        raise ValueError(f"kernel needs a head dim in {HEAD_DIMS} and Nkv >= 1; "
                         f"got hd={hd}, Nkv={Nkv}")
    args = [_build.operand(q, "q", (B, Nq, heads, hd)),
            _build.operand(k, "k", (B, Nkv, heads, hd)),
            _build.operand(v, "v", (B, Nkv, heads, hd))]
    if any(a.device != q.device for a in args):
        raise ValueError("flash_cross_attention: all operands must be on q's device")
    out = torch.empty_like(args[0])
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_flash_attention(*[a.data_ptr() for a in args], out.data_ptr(),
                                          B, Nq, Nkv, heads, hd, float(scale), stream)
    _build.check(lib, status, "flash_cross_attention")
    flash_cross_attention.launches += 1
    return out


flash_cross_attention.launches = 0
