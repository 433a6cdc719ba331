"""K1: fused LayerNorm + q-proj + cross-attention + out-proj + residual.

Port of `upliftingtabletennis_tpu/ops/fused_attention.py`. The function is

    out = x + concat_h softmax(q_h k_hᵀ / sqrt(hd)) v_h · Wp + bp,
    q = LN(x) · Wq + bq

with K/V already projected (the spatially reduced keys/values, computed
outside with torch ops as the JAX model computes them with XLA).

`fused_attention_block` dispatches on the tensor's device: CUDA tensors go
to the hand-written Hopper kernels (`csrc/fused_attention.cu`: LN(x), an
attention kernel per (128-row tile, head, sample) writing the head outputs O,
then the out-projection with the residual; `attention_plan` gives the
launches' grids and shared memory; one count per call), CPU tensors
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
import functools
from types import MappingProxyType
from typing import Mapping

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["fused_attention_block", "fused_attention_block_trainable", "attention_block_plain",
           "attention_plan"]

_SOURCE = "fused_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KV_CHUNK = 64  # keys per K/V chunk (fused_attention.cuh BKV)
_KV_STAGES = 3  # depth of the K/V ring (KV_STAGES)


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


def _lib(source=_SOURCE, entry="uttk_fused_attention", nargs=0):
    lib = _build.library(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [_I] * nargs + [_P] * 12 + [_I] * 5 + [_F, _F, _P]
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=256)
def attention_plan(B: int, N: int, C: int, heads: int) -> Mapping:
    """How K1 runs at these shapes: its launches (the LayerNorm over 32-row tiles, the
    attention kernel over (128-row tile, head, sample) and, with several heads, the
    out-projection over 128 x 128 tiles), their grids and the dynamic shared memory of
    those that use it, by the formulas the C side checks (`attn_smem`, `gemm_smem`).
    Raises for a shape the kernel does not take."""
    hd = C // heads if heads and C % heads == 0 else 0
    if C % 16 or hd not in (16, 32, 48, 64) or B < 1 or N < 1:
        raise ValueError(f"kernel needs C % 16 == 0 and a head dim of 16, 32, 48 or 64; "
                         f"got C={C}, heads={heads}")
    tile = _build.GEMM_TILE
    return MappingProxyType({
        "hd": hd, "rows_per_block": _build.BM,
        "ln_grid": (-(-(B * N) // _build.LN_ROWS),),
        "attention_grid": (-(-N // _build.BM), heads, B),
        "attention_smem": 2 * (2 * (_build.BM + hd) * _build.LDK
                               + _KV_STAGES * 2 * _KV_CHUNK * (hd + _build.PAD)),
        # one head: the attention kernel applies the out-projection itself
        "proj_grid": () if heads == 1 else (-(-(B * N) // tile), -(-C // tile)),
        "proj_smem": 0 if heads == 1 else _build.gemm_smem()})


def _operands(x, heads, gamma, beta, wq, bq, k, v, wp, bp):
    B, N, C = x.shape
    hd = C // heads
    Nkv = k.shape[1]
    if Nkv < 1:
        raise ValueError(f"kernel needs Nkv >= 1; got Nkv={Nkv}")
    attention_plan(B, N, C, heads)  # raises for a shape the kernel does not take
    args = [
        _build.operand(x, "x", (B, N, C)),
        _build.operand(gamma, "gamma", (C,)), _build.operand(beta, "beta", (C,)),
        _build.operand(wq.t(), "wq", (C, C)), _build.operand(bq, "bq", (C,)),
        _build.operand(k, "k", (B, Nkv, heads, hd)), _build.operand(v, "v", (B, Nkv, heads, hd)),
        _build.operand(wp.t(), "wp", (C, C)), _build.operand(bp, "bp", (C,)),
    ]
    if any(a.device != x.device for a in args):
        raise ValueError("fused_attention_block: all operands must be on x's device")
    return args, (B, N, C, heads, Nkv)


def run_kernel(lib, entry, lead, args, dims, eps, what):
    """Launch K1's C entry `entry` (`lead`: the arguments before the pointers, the probe's
    mode) with its scratch (LN(x) and the head outputs O); returns the output."""
    B, N, C, heads, Nkv = dims
    x = args[0]
    scratch = torch.empty((2, B, N, C), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in args] + [scratch[0].data_ptr(), scratch[1].data_ptr(),
                                           out.data_ptr()]
    status = _build.call_on_device(x, lambda stream: getattr(lib, entry)(
        *lead, *ptrs, B, N, C, heads, Nkv, float(eps), float((C // heads) ** -0.5), stream))
    _build.check(lib, status, what)
    return out


def _launch(x, heads, gamma, beta, wq, bq, k, v, wp, bp, eps):
    args, dims = _operands(x, heads, gamma, beta, wq, bq, k, v, wp, bp)
    out = run_kernel(_lib(), "uttk_fused_attention", (), args, dims, eps, "fused_attention_block")
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
