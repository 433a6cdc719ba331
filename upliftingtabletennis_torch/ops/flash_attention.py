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

It is differentiable: when autograd would record the call, it runs through
`flash_cross_attention_diff`, the counterpart of the JAX custom VJP of the
same name. Its forward is the kernel; its backward recomputes the attention
densely through `cross_attention_plain` (Nkv stays small by SegFormer's
spatial reduction) and returns that graph's gradients.

Layout: q (B, Nq, h, hd), k and v (B, Nkv, h, hd), as in the JAX function.
The kernel reads that layout directly through TMA tensor maps (the JAX
wrapper's transposes to (B·h, N, hd) are a TPU layout).
"""
from __future__ import annotations

import ctypes

import torch

from upliftingtabletennis_torch.ops import _build

__all__ = ["flash_cross_attention", "flash_cross_attention_diff", "cross_attention_plain"]

_SOURCE = "flash_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (32, 64)  # SegFormer b0 and b2
# mirrors of csrc/flash_attention.cu: keys per K/V chunk and the depth of their ring
CHUNK, STAGES = 128, 4


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


def _launch(q, k, v, scale):
    if scale <= 0:  # the kernel folds a positive scale into its base-2 exponent
        q, scale = (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)
    B, Nq, heads, hd = q.shape
    Nkv = k.shape[1]
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


class _FlashCrossAttention(torch.autograd.Function):
    """K3 forward, dense recompute backward (the JAX `_flash_diff_fwd` / `_flash_diff_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_cross_attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = cross_attention_plain(*inputs, ctx.scale)
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        return (*[next(grads) if t.requires_grad else None for t in inputs], None)


def flash_cross_attention_diff(q, k, v, scale=None):
    """`flash_cross_attention` as an autograd Function: K3's forward and a backward that
    recomputes `cross_attention_plain` densely (port of the JAX `flash_cross_attention_diff`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashCrossAttention.apply(q, k, v, float(scale))


def flash_cross_attention(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v per (sample, head); q (B, Nq, h, hd), k, v (B, Nkv, h, hd).

    scale defaults to hd ** -0.5. Returns (B, Nq, h, hd) in q's dtype. Differentiable
    (through `flash_cross_attention_diff`).
    """
    B, Nq, heads, hd = q.shape
    Nkv = k.shape[1]
    if k.shape != (B, Nkv, heads, hd) or v.shape != k.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if scale is None:
        scale = hd ** -0.5
    if _build.needs_grad(q, k, v):
        return flash_cross_attention_diff(q, k, v, scale)
    if _build.uses_kernel(q, "flash_cross_attention"):
        return _launch(q, k, v, scale)
    return cross_attention_plain(q, k, v, scale)


flash_cross_attention.launches = 0
