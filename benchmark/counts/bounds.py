"""The least time of each port kernel's work, from its shapes: the larger of its operations
over the chip's peak rate and its bytes over the peak bandwidth, each input read once and
each output written once (bf16 operands, f32 where named). Frozen copies of the bounds of
`chip_smoke.py` (`k1_bound` ... `k6_bound`); each returns (seconds, "bytes" | "operations").
"""
from __future__ import annotations

from benchmark.counts.peaks import BF16_TC_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, SFU_PER_S

K6_FLOPS_PER_PAIR = 20  # max, min, sub, add, mul, div, compare over one pair of boxes


def _bound(t_bytes: float, t_ops: float):
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(B, N, C, heads, Nkv, softmax=True):
    """K1, the attention half-block of a MiT block: LN, q projection, softmax(q k^T) v,
    out projection and residual. x, k, v, the weights read once; the output written once."""
    nbytes = 2 * (2 * B * N * C + 2 * B * Nkv * C + 2 * C * C + 4 * C)
    flops = 4 * B * N * C * C + 4 * B * N * Nkv * C  # q/out projections, QK^T, PV
    exps = B * N * Nkv * heads if softmax else 0
    return _bound(nbytes / HBM_BYTES_PER_S, max(flops / BF16_TC_FLOPS, exps / SFU_PER_S))


def k2_bound(B, N, C, HID, taps=9):
    """K2, the FFN half-block: LN, fc1, depthwise 3x3 + GELU, fc2 and residual."""
    nbytes = 2 * (2 * B * N * C + 2 * C * HID + 9 * HID + 2 * HID + 3 * C)
    flops = 4 * B * N * C * HID  # fc1 and fc2 on the tensor cores
    dw_flops = 2 * taps * B * N * HID  # depthwise 3x3 on the f32 cores
    return _bound(nbytes / HBM_BYTES_PER_S, max(flops / BF16_TC_FLOPS, dw_flops / FP32_FLOPS))


def k3_bound(B, Nq, Nkv, heads, hd):
    """K3, cross attention of merged queries: q, k, v read once, the output written once."""
    nbytes = 2 * (2 * B * Nq * heads * hd + 2 * B * Nkv * heads * hd)
    flops = 4 * B * heads * Nq * Nkv * hd  # QK^T and PV on the tensor cores
    exps = B * heads * Nq * Nkv
    return _bound(nbytes / HBM_BYTES_PER_S, max(flops / BF16_TC_FLOPS, exps / SFU_PER_S))


def k4_bound(B, H, W, C):
    """K4's forward, the depthwise 3x3: x read once, the output written once (bf16); 18 f32
    operations per element."""
    nbytes = 2 * (2 * B * H * W * C + 10 * C)
    return _bound(nbytes / HBM_BYTES_PER_S, 18 * B * H * W * C / FP32_FLOPS)


def k4_bwd_bound(B, H, W, C):
    """K4's backward: g and x read once, dx written once (bf16), the taps read and dw and db
    written once; 38 f32 operations per element (dx's 9 and dw's 9 multiply-adds, db's add)."""
    nbytes = 2 * (3 * B * H * W * C + 9 * C) + 4 * 10 * C
    return _bound(nbytes / HBM_BYTES_PER_S, 38 * B * H * W * C / FP32_FLOPS)


def k5_bound(ks, B, H, W, Ci, Co, residual):
    """K5, a stride-1 conv (3x3: K5a, 1x1: K5b) with bias, ReLU and optional residual."""
    npix = B * H * W
    nbytes = 2 * npix * (Ci + Co * (2 if residual else 1)) + 2 * ks * ks * Ci * Co + 4 * Co
    flops = 2 * npix * ks * ks * Ci * Co
    return _bound(nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS)


def k6_bound(n):
    """K6, one NMS mask: dets (N, 5) f32 read once, the suppression words and the keep mask
    written once; K6_FLOPS_PER_PAIR f32 operations on each of the N (N - 1) / 2 pairs."""
    nbytes = 20 * n + 8 * n * (-(-n // 64)) + n
    flops = K6_FLOPS_PER_PAIR * n * (n - 1) / 2
    return _bound(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
