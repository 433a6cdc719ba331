"""K1: fused LayerNorm + q-proj + cross-attention + out-proj + residual.

Port of `upliftingtabletennis_tpu/ops/fused_attention.py`. The function is

    out = x + concat_h softmax(q_h k_hᵀ / sqrt(hd)) v_h · Wp + bp,
    q = LN(x) · Wq + bq

with K/V already projected (the spatially reduced keys/values, computed
outside with torch ops as the JAX model computes them with XLA).

`fused_attention_block` dispatches on the tensor's device: CUDA tensors go
to the hand-written Hopper kernel (`csrc/fused_attention.cu`), CPU tensors
to `attention_block_plain`, the plain PyTorch version of the same function
that the tests hold against the JAX kernel. A build or launch failure
raises; nothing falls back to the plain version on CUDA.

It is differentiable: when autograd would record the call, it runs through
`fused_attention_block_trainable`, the counterpart of the JAX custom VJP of
the same name. Its forward is the kernel and saves only the inputs; its
backward recomputes `attention_block_plain` (whose casts are those of the JAX
`_ref_attention_block`) and returns that graph's gradients, so the (N, Nkv)
attention weights are never stored.

Weights use the JAX layout at this interface (wq, wp are (in, out)), so a
test compares like with like; the kernel reads them as the torch Linear
layout (out, in), which is `wq.t()` (no copy for `linear.weight.t()`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["fused_attention_block", "fused_attention_block_trainable", "attention_block_plain"]

_SOURCE = "fused_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def attention_block_plain(x, heads, gamma, beta, wq, bq, k, v, wp, bp, eps=1e-6):
    """Plain PyTorch version of K1, with the kernel's casts.

    x (B, N, C); k, v (B, Nkv, heads, hd); gamma, beta, bq, bp (C,);
    wq, wp (C, C) in (in, out) layout. LN, logits, softmax and every
    product accumulate in f32; y, q, the attention weights and the head
    outputs round to x.dtype where the kernel rounds them (no-ops in f32).
    """
    B, N, C = x.shape
    hd = C // heads
    dt = x.dtype
    xf = x.float()
    y = F.layer_norm(xf, (C,), gamma.float(), beta.float(), eps).to(dt)
    q = (y.float() @ wq.float() + bq.float()).to(dt).reshape(B, N, heads, hd)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.to(dt).float()) * hd ** -0.5
    w = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bhnm,bmhd->bnhd", w.float(), v.to(dt).float())
    o = o.to(dt).reshape(B, N, C)
    return (xf + o.float() @ wp.float() + bp.float()).to(dt)


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_fused_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 5 + [_F, _F, _P]
        fn.restype = _I
    return lib


def _launch(x, heads, gamma, beta, wq, bq, k, v, wp, bp, eps):
    B, N, C = x.shape
    hd = C // heads
    Nkv = k.shape[1]
    if C % 16 or hd not in (16, 32, 48, 64) or Nkv < 1:
        raise ValueError(f"kernel needs C % 16 == 0, a head dim of 16, 32, 48 or 64 and "
                         f"Nkv >= 1; got C={C}, hd={hd}, Nkv={Nkv}")
    args = [
        _build.operand(x, "x", (B, N, C)),
        _build.operand(gamma, "gamma", (C,)), _build.operand(beta, "beta", (C,)),
        _build.operand(wq.t(), "wq", (C, C)), _build.operand(bq, "bq", (C,)),
        _build.operand(k, "k", (B, Nkv, heads, hd)), _build.operand(v, "v", (B, Nkv, heads, hd)),
        _build.operand(wp.t(), "wp", (C, C)), _build.operand(bp, "bp", (C,)),
    ]
    if any(a.device != x.device for a in args):
        raise ValueError("fused_attention_block: all operands must be on x's device")
    out = torch.empty_like(args[0])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_fused_attention(
            *[a.data_ptr() for a in args], out.data_ptr(),
            B, N, C, heads, Nkv, float(eps), float(hd ** -0.5), stream)
    _build.check(lib, status, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


class _FusedAttentionBlock(torch.autograd.Function):
    """K1 forward, recompute backward (the JAX `_fused_attention_fwd` / `_fused_attention_bwd`)."""

    @staticmethod
    def forward(ctx, x, H, W, heads, eps, *params):
        ctx.save_for_backward(x, *params)
        ctx.shape = (heads, eps)
        return fused_attention_block(x, H, W, heads, *params, eps=eps)

    @staticmethod
    def backward(ctx, g):
        heads, eps = ctx.shape
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:1] +
                                     ctx.needs_input_grad[5:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = attention_block_plain(inputs[0], heads, *inputs[1:], eps=eps)
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        dx, *dparams = [next(grads) if t.requires_grad else None for t in inputs]
        return (dx, None, None, None, None, *dparams)


def fused_attention_block_trainable(x, H: int, W: int, heads: int, gamma, beta, wq, bq, k, v,
                                    wp, bp, eps: float = 1e-6):
    """`fused_attention_block` as an autograd Function: K1's forward, saving only the
    inputs, and a backward that recomputes `attention_block_plain` (port of the JAX
    `fused_attention_block_trainable`)."""
    return _FusedAttentionBlock.apply(x, H, W, heads, eps, gamma, beta, wq, bq, k, v, wp, bp)


def fused_attention_block(x, H: int, W: int, heads: int, gamma, beta, wq, bq, k, v, wp, bp,
                          eps: float = 1e-6):
    """out = x + proj(attn(q(LN(x)), k, v)); x (B, N, C), N == H*W.

    k, v: (B, Nkv, heads, hd), the already-projected keys/values.
    gamma/beta (C,), wq/wp (C, C) as (in, out), bq/bp (C,). H and W are
    unused by the math (attention has no spatial halo); they are checked
    against N as the JAX function checks them. Differentiable (through
    `fused_attention_block_trainable`).
    """
    B, N, C = x.shape
    if N != H * W or C % heads:
        raise ValueError(f"bad shapes: N={N}, H={H}, W={W}, C={C}, heads={heads}")
    params = (gamma, beta, wq, bq, k, v, wp, bp)
    if _build.needs_grad(x, *params):
        return fused_attention_block_trainable(x, H, W, heads, *params, eps=eps)
    if _build.uses_kernel(x, "fused_attention_block"):
        return _launch(x, heads, *params, eps)
    return attention_block_plain(x, heads, *params, eps)


fused_attention_block.launches = 0
