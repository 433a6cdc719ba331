"""K2: fused LayerNorm + MixFFN + residual (the SegFormer FFN half-block).

Port of `upliftingtabletennis_tpu/ops/fused_ffn.py` (`fused_ln_ffn`, the
v1 kernel; v2/v3 compute the same function in TPU lane layouts). The
function is

    out = x + fc2(gelu_erf(dw3x3(fc1(LN(x))) + bdw)) + b2

with the depthwise conv zero-padding the hidden tensor at the image border.

`fused_ln_ffn` dispatches on the tensor's device: CUDA tensors go to the
hand-written Hopper kernels (`csrc/fused_ffn.cu`) along the plan `ffn_plan`
chooses for the shape: one fused launch at the narrow widths, or the split
route at the wide ones (LN(x), fc1, the stencil + GELU and fc2 + residual as
four launches through bf16 tensors in device memory, where the plain version
rounds them); one count per call. CPU tensors go to
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
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops.dwconv import depthwise_conv3x3

__all__ = ["fused_ln_ffn", "fused_ln_ffn_trainable", "ln_ffn_plain", "ln_ffn_ref", "ffn_plan",
           "FfnPlan"]

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


def _lib(source=_SOURCE, entry="uttk_fused_ffn", nargs=0):
    lib = _build.library(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [_I] * nargs + [_P] * 11 + [_I] * 7 + [_F, _P]
        fn.restype = _I
    return lib


WIDTHS = (32, 64, 128, 160, 256, 320, 512)  # the SegFormer b0/b2 widths K2 takes
FUSED_WIDTHS = (32, 64)  # the fused route's instantiations (fused_ffn.cu)
FUSED_MAX_C = 64  # the plan runs widths up to this one fused, wider ones split (measured)
TILE_WIDTHS = (16, 8, 32)  # 128-pixel tiles TH x TW; on a tie of padded area the first wins
_HC, _STENCIL_CHUNKS = 64, 4  # hidden channels per chunk; chunks per stencil block


@dataclass(frozen=True)
class FfnPlan:
    """How K2 runs at one shape (`ffn_plan`)."""

    route: str        # "fused" (one launch) or "split" (LN, fc1, stencil, fc2: four launches)
    th: int           # pixel tile rows x columns of the tile or stencil kernel: TH * TW == 128
    tw: int
    grid: tuple       # tile kernel (tiles, 1, B) or stencil kernel (tiles, ceil(HID / 256), B)
    smem: int         # dynamic shared memory of one of those blocks
    ln_grid: tuple    # split: (ceil(B*H*W / 32),); () when fused
    fc1_grid: tuple   # split: (ceil(B*H*W / 128), ceil(HID / 128)); () when fused
    fc2_grid: tuple   # split: (ceil(B*H*W / 128), ceil(C / 128)); () when fused
    gemm_smem: int    # split: dynamic shared memory of a block of fc1 or fc2; 0 when fused


def halo_rows(tw: int) -> int:
    """Rows of the halo tile of a 128-pixel tile (fused_ffn.cuh `halo_rows`)."""
    return -(-((_build.BM // tw + 2) * (tw + 2)) // 16) * 16


def tile_smem(C: int, tw: int) -> int:
    """Dynamic shared memory of one fused tile block (fused_ffn.cuh `tile_smem`)."""
    mp, ldk, ldy = halo_rows(tw), _build.LDK, C + _build.PAD
    return 2 * (2 * C * ldk + _build.BM * ldk + mp * ldk + mp * ldy + 2 * _HC * ldy)


def stencil_smem(tw: int) -> int:
    """Dynamic shared memory of one stencil block (fused_ffn.cuh `stencil_smem`)."""
    return 2 * 2 * halo_rows(tw) * _build.LDK


@functools.lru_cache(maxsize=256)
def ffn_plan(B: int, H: int, W: int, C: int, HID: int, route: str | None = None) -> FfnPlan:
    """K2's launch plan at (B, H, W, C, HID): the route (fused up to FUSED_MAX_C, split
    above, or `route` to compare the two where both are instantiated), the tile width
    that pads H and W the least, the grids and the shared memory. Raises ValueError for a
    shape without an instantiation."""
    route = route or ("fused" if C <= FUSED_MAX_C else "split")
    fused = route == "fused"
    if C not in (FUSED_WIDTHS if fused else WIDTHS):
        raise ValueError(f"fused_ln_ffn: the kernel has no {route} instantiation for C={C}")
    if HID % _HC or HID < _HC or min(B, H, W) < 1:
        raise ValueError(f"kernel needs HID % 64 == 0 and B, H, W >= 1; got HID={HID}, "
                         f"B={B}, H={H}, W={W}")

    def padded(tw):
        th = _build.BM // tw
        return -(-H // th) * th * (-(-W // tw) * tw), halo_rows(tw)

    tw = min(TILE_WIDTHS, key=padded)
    th = _build.BM // tw
    tiles = -(-H // th) * -(-W // tw)
    if fused:
        return FfnPlan(route, th, tw, (tiles, 1, B), tile_smem(C, tw), (), (), (), 0)
    M, tile = B * H * W, _build.GEMM_TILE
    return FfnPlan(route, th, tw, (tiles, -(-HID // (_HC * _STENCIL_CHUNKS)), B), stencil_smem(tw),
                   (-(-M // _build.LN_ROWS),), (-(-M // tile), -(-HID // tile)),
                   (-(-M // tile), -(-C // tile)), _build.gemm_smem())


def _operands(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2):
    B, N, C = x.shape
    HID = w1.shape[1]
    plan = ffn_plan(B, H, W, C, HID)  # raises for a width without an instantiation
    args = [
        _build.operand(x, "x", (B, N, C)),
        _build.operand(gamma, "gamma", (C,)), _build.operand(beta, "beta", (C,)),
        _build.operand(w1.t(), "w1", (HID, C)), _build.operand(b1, "b1", (HID,)),
        _build.operand(dw.reshape(9, HID), "dw", (9, HID)), _build.operand(bdw, "bdw", (HID,)),
        _build.operand(w2.t(), "w2", (C, HID)), _build.operand(b2, "b2", (C,)),
    ]
    if any(a.device != x.device for a in args):
        raise ValueError("fused_ln_ffn: all operands must be on x's device")
    return args, plan


def run_kernel(lib, entry, lead, args, plan, H, W, eps, what):
    """Launch K2's C entry `entry` (`lead`: the arguments before the pointers, the probe's
    mode) with `plan`; the split route gets its scratch (y, h and g). Returns the output."""
    x = args[0]
    B, N, C = x.shape
    HID = args[3].shape[0]
    fused = plan.route == "fused"
    work = None if fused else torch.empty(B * N * (C + 2 * HID), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in args] + [None if fused else work.data_ptr(), out.data_ptr()]
    status = _build.call_on_device(x, lambda stream: getattr(lib, entry)(
        *lead, *ptrs, B, H, W, C, HID, int(fused), plan.tw, float(eps), stream))
    _build.check(lib, status, what)
    return out


def _launch(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2, eps):
    args, plan = _operands(x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2)
    out = run_kernel(_lib(), "uttk_fused_ffn", (), args, plan, H, W, eps, "fused_ln_ffn")
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
