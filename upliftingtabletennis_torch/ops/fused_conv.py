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

How a conv runs on the card is its launch plan, `conv_plan(ks, Ci, Co)`: the
route (`tma` for the 3x3 convs, whose halo tiles TMA loads; `stem` for the 3x3
convs with Ci < 16, whose halo rows the producer warps load; `mma` for the 1x1
convs), the output channels per block, the pixel tile and the ring depth (or,
for K5b, the warps along the pixels). The kernel takes the plan as arguments
and runs the instantiation that matches it.

Weights use the JAX layout at this interface: (3, 3, Ci, Co) and (Ci, Co).
The kernel reads them as `pack(w, b)` lays them out: (round16(Co), K) bf16
with column tap * Cp + ci, zero-padded, and an f32 bias. For a 3x3 conv Cp is
max(Ci, 16) and K = 9 Cp (a stem's taps are widened to 16 channels, as its
halo tile is); for a 1x1 conv Cp = Ci and K = round16(Ci). A caller that runs
the same conv many times (the HRNet) packs once and passes the `Packed`
operands in place of `w` and `b`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build

__all__ = ["conv3x3_bias_act", "conv1x1_bias_act", "conv3x3_bias_act_plain",
           "conv1x1_bias_act_plain", "pack", "unpack", "Packed", "conv_plan", "ConvPlan"]

_SOURCE = "fused_conv.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_NO_INSTANTIATION = -1  # uttk_fused_conv: no kernel for this plan


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


def _taps_channels(ks: int, ci: int) -> int:
    """Channels per tap in the packed weight: a 3x3 stem's taps are widened to 16."""
    return max(ci, 16) if ks == 3 else ci


def pack(w: torch.Tensor, b: Optional[torch.Tensor] = None) -> Packed:
    """(3, 3, Ci, Co) or (Ci, Co) weight, (Co,) bias -> the kernel's operands."""
    w4 = w if w.ndim == 4 else w[None, None]
    ks, _, ci, co = w4.shape
    cp = _taps_channels(ks, ci)
    wk = F.pad(w4.permute(3, 0, 1, 2), (0, cp - ci)).reshape(co, ks * ks * cp)
    wk = F.pad(wk, (0, -wk.shape[1] % 16, 0, -co % 16)).to(torch.bfloat16).contiguous()
    return Packed(wk, None if b is None else b.float().contiguous(), ks, ci, co)


def unpack(p: Packed):
    """The (3, 3, Ci, Co) or (Ci, Co) weight (bf16) and the bias of packed operands."""
    cp = _taps_channels(p.ks, p.ci)
    w = p.weight[:p.co, :p.ks * p.ks * cp].reshape(p.co, p.ks, p.ks, cp)[..., :p.ci]
    w = w.permute(1, 2, 3, 0)
    return (w if p.ks == 3 else w[0, 0]), p.bias


class ConvPlan(NamedTuple):
    """How K5 runs one conv on the card (`conv_plan`)."""
    route: str   # "tma" / "stem" (K5a: halo tiles by TMA / by the producer warps), "mma" (K5b)
    nb: int      # output channels per block
    th: int      # the block's pixel tile, th x tw
    tw: int
    depth: int   # K5a: stages of the halo-tile ring; K5b: warps along the pixels
    smem: int    # dynamic shared memory of one block


CONV3_TILES = ((16, 32), (16, 16), (8, 16))  # K5a's pixel tiles, largest first
CONV3_MAX_STAGES = 4
CONV3_MAX_ACC = 64  # f32 accumulators per consumer thread: (th * tw / 128) * nb / 2
# K5b's instantiations: (Ci, Co rounded up to 16, 32, 64 or 128) -> (nb, th, tw, warps along M)
CONV1_TILES = {(64, 32): (32, 8, 16, 4), (64, 128): (128, 8, 16, 2), (32, 128): (128, 8, 16, 2),
               (32, 16): (16, 8, 32, 8), (64, 16): (16, 8, 32, 8), (128, 16): (16, 8, 16, 8),
               (128, 32): (32, 8, 16, 4), (128, 64): (64, 8, 16, 4), (16, 16): (16, 8, 32, 8)}
# K5a's instantiations in fused_conv.cu: (Ci, Co) of the HRNet's 3x3 convs
CONV3_SHAPES = ((9, 64), (3, 64), (64, 64), (32, 32), (16, 16), (128, 16), (128, 128))


def _r1024(n: int) -> int:
    return -(-n // 1024) * 1024


def conv3_smem(ci: int, nb: int, th: int, tw: int, stages: int) -> int:
    """Dynamic shared memory of one K5a block (fused_conv.cu `Conv3::SMEM`): the ring of
    halo tiles (boxes of <= 64 channels) with the residual's two halves, the output's
    two halves, the weights, the bias and the barriers, from a 1024-byte aligned base."""
    cis = max(ci, 16)
    cb = min(cis, 64)
    half = th * tw // 2 * nb * 2
    stage = cis // cb * _r1024((th + 2) * (tw + 2) * cb * 2) + 2 * half
    return 1024 + stages * stage + 2 * half + _r1024(nb * 9 * cis * 2) + 4 * nb + 16 * stages


def conv1_smem(ci: int, nb: int, th: int, tw: int, wm: int) -> int:
    """Dynamic shared memory of one K5b block (fused_conv.cu `Conv1::SMEM`)."""
    kp, p = -(-ci // 16) * 16, th * tw
    return 2 * nb * (kp + 8) + max(2 * p * (ci + 8), 4 * p * (nb + 4)) + 4 * nb


def _stages(ci, nb, th, tw):
    fits = [s for s in range(1, CONV3_MAX_STAGES + 1)
            if conv3_smem(ci, nb, th, tw, s) <= _build.SMEM_LIMIT]
    return max(fits, default=0)


@functools.lru_cache(maxsize=64)
def conv_plan(ks: int, ci: int, co: int) -> ConvPlan:
    """K5's launch plan for a (ks, Ci, Co) conv. 3x3: the widest channel group (64, 32
    or 16 dividing Co) whose weights leave room for two stages of the smallest tile;
    then the largest tile that fits three stages (two where none does) within
    CONV3_MAX_ACC accumulators per thread; as many stages as fit, up to four. 1x1:
    CONV1_TILES. Raises ValueError for a conv the kernel has no instantiation for."""
    if ks == 3:
        if (ci, co) in CONV3_SHAPES:
            for nb in (n for n in (64, 32, 16) if co % n == 0):
                if _stages(ci, nb, *CONV3_TILES[-1]) < 2:
                    continue
                tiles = [t for t in CONV3_TILES if t[0] * t[1] // 128 * nb // 2 <= CONV3_MAX_ACC]
                for need in (3, 2):
                    for th, tw in tiles:
                        stages = _stages(ci, nb, th, tw)
                        if stages >= need:
                            return ConvPlan("stem" if ci < 16 else "tma", nb, th, tw, stages,
                                            conv3_smem(ci, nb, th, tw, stages))
    elif ks == 1:
        bucket = next((b for b in (16, 32, 64, 128) if co <= b), None)
        if (ci, bucket) in CONV1_TILES:
            nb, th, tw, wm = CONV1_TILES[ci, bucket]
            return ConvPlan("mma", nb, th, tw, wm, conv1_smem(ci, nb, th, tw, wm))
    raise ValueError(f"the kernel has no instantiation for ks={ks}, Ci={ci}, Co={co}")


def _lib():
    lib = _build.library(_SOURCE)
    fn = lib.uttk_fused_conv
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 11 + [_P]
        fn.restype = _I
    return lib


def _launch(wrapper, x, p: Packed, residual, relu):
    name = wrapper.__name__
    B, H, W, Ci = x.shape
    try:
        plan = conv_plan(p.ks, Ci, p.co)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    x = _build.operand(x, "x", (B, H, W, Ci))
    k = p.ks * p.ks * _taps_channels(p.ks, Ci)
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
                                     out.data_ptr(), B, H, W, p.ks, Ci, p.co, int(relu), plan.nb,
                                     plan.th, plan.tw, plan.depth, stream)
    if status == _NO_INSTANTIATION:
        raise ValueError(f"{name}: the kernel has no instantiation for the plan {plan}")
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
        raise RuntimeError(f"{name}: the CUDA kernel has no backward (the HRNet trainers run "
                           f"their convolutions unfolded through F.conv2d); call it under "
                           f"torch.no_grad()")
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
