"""K1, K2, K3, K4, K5, K6 and S1 CUDA kernels, and the phase probes of K1 and K2, against
their plain PyTorch versions on the card.

These tests need an NVIDIA Hopper GPU and nvcc and skip without them. They import
only torch, so they run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Shapes are small and ragged (N below one 128-row tile or not a multiple of it, Nkv of
1, below one 64-key chunk, ragged and b0's 2040, every (C, heads) of b0 and b2, H and
W not multiples of the FFN or conv tile; every K2 width and plan of b0 and b2 (fused
and two-pass), and the plans' shared memory against the C side's formula; every probe
mode of K1 and K2; K3's Nq and Nkv not multiples of its 128-row and 128-key
tiles, Nkv around its chunk and its ring at hd 32 and 64, a negative and a zero scale;
every K5a launch plan at ragged H and W with and without the residual, and the K5
plans' shared memory against the C side's; the stems' Ci = 3 and 9, the heads' Co = 3
and 13). The plain version runs in
f32 on the same bf16 inputs; tolerances as in chip_smoke.py: |kernel - plain| <=
6e-2 + 2e-2 |plain| for K1 and K2, 1e-2 + 8e-3 |plain| for K5, and for K3 the bound
of its bf16 roundings, 2^-8 (|plain| + softmax(q kᵀ) |v|) per element (`k3_limit`).
K6 (box NMS) is exact: its suppression words equal the plain version's bit for bit
and its keep mask the plain resolve's, at ragged N (one box, N around the 64-box
word) and on boxes where ties and exact roundings decide. K4 (depthwise 3x3) is held
at K5's tolerance (only its output is rounded to bf16), forward and dx, and dw and db
at chip_smoke.py's K4 sum limit (1e-3 max |plain| + 2^-8 |plain|: the f32 sums in
another order, rounded to bf16), at the b2 hidden shapes of the 1600x896 trainer and
ragged ones; its backward's dw and db repeat bit for bit, and its launchers refuse a
plan that is not one for their tiles. The differentiable wrappers
(K1, K2, K3 and K4 through their autograd Functions) give the gradients of their f32
plain versions within 5e-2 in relative norm per input (bf16 operands and
recomputation); a b2 SegFormer in training mode gives every parameter a finite
gradient; K5, which has no backward yet, raises under grad.
"""
import pytest
import torch

from upliftingtabletennis_torch.models.segformer import SegFormerNet
from upliftingtabletennis_torch.ops import dwconv as k4
from upliftingtabletennis_torch.ops.dwconv import (depthwise_conv3x3, dwconv3x3_backward,
                                                   dwconv3x3_backward_plain, dwconv3x3_plain)
from upliftingtabletennis_torch.ops.flash_attention import (cross_attention_plain,
                                                            flash_cross_attention)
from upliftingtabletennis_torch.ops.fused_attention import (attention_block_plain,
                                                           fused_attention_block)
from upliftingtabletennis_torch.ops.fused_conv import (conv1x1_bias_act, conv1x1_bias_act_plain,
                                                      conv3x3_bias_act, conv3x3_bias_act_plain,
                                                      pack)
from upliftingtabletennis_torch.ops import flash_attention as k3
from upliftingtabletennis_torch.ops import fused_conv as k5
from upliftingtabletennis_torch.ops.fused_ffn import fused_ln_ffn, ln_ffn_plain
from upliftingtabletennis_torch.ops import fused_attention as fa
from upliftingtabletennis_torch.ops import fused_ffn as k2
from upliftingtabletennis_torch.ops import nms as k6
from upliftingtabletennis_torch.tools import probe_attn_phases as probe_attn
from upliftingtabletennis_torch.tools import probe_ffn_phases as probe_ffn

pytestmark = pytest.mark.cuda
ATOL, RTOL = 6e-2, 2e-2
K5_ATOL, K5_RTOL = 1e-2, 8e-3
GRAD_REL = 5e-2  # per-input ||g_kernel - g_plain|| / ||g_plain||, as chip_smoke.py's train phase
K4_SUM_ATOL, K4_SUM_RTOL = 1e-3, 2.0 ** -8  # dw and db, as chip_smoke.py's k4 phase


def k3_limit(q, k, v, want, scale=None):
    """K3's limit per element, as in chip_smoke.py: the kernel rounds each probability
    (relative error at most 2^-8, bf16's unit roundoff; its row sum stays f32) and its
    output (2^-8 |out|) to bf16, so |kernel - plain| <= 2^-8 (softmax(q kᵀ) |v| + |out|)
    to first order."""
    return 2.0 ** -8 * (want.abs() + cross_attention_plain(q.float(), k.float(), v.float().abs(),
                                                          scale))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the f32 plain versions in full f32 (no TF32 in matmuls or cuDNN convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,W,C,heads,Nkv", [
    (2, 7, 9, 64, 2, 24), (1, 13, 11, 32, 1, 130), (2, 5, 8, 160, 5, 64), (1, 3, 50, 512, 8, 65),
])
def test_k1_kernel_matches_plain(gen, B, H, W, C, heads, Nkv):
    hd = C // heads
    x = _rnd(gen, B, H * W, C)
    args = (1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), _rnd(gen, C, C, std=C ** -0.5),
            _rnd(gen, C, std=0.1), _rnd(gen, B, Nkv, heads, hd), _rnd(gen, B, Nkv, heads, hd),
            _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.1))
    before = fused_attention_block.launches
    got = fused_attention_block(x, H, W, heads, *args)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    want = attention_block_plain(x.float(), heads, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,H,W,C", [
    (2, 9, 17, 64), (1, 10, 9, 128), (1, 5, 3, 320), (2, 6, 7, 512), (2, 11, 13, 32),
    (1, 7, 10, 160),
])
def test_k2_kernel_matches_plain(gen, B, H, W, C):
    HID = 4 * C
    x = _rnd(gen, B, H * W, C)
    args = (1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), _rnd(gen, C, HID, std=C ** -0.5),
            _rnd(gen, HID, std=0.1), _rnd(gen, 3, 3, HID, std=1 / 3), _rnd(gen, HID, std=0.1),
            _rnd(gen, HID, C, std=HID ** -0.5), _rnd(gen, C, std=0.1))
    before = fused_ln_ffn.launches
    got = fused_ln_ffn(x, H, W, *args)
    torch.cuda.synchronize()
    assert fused_ln_ffn.launches == before + 1
    want = ln_ffn_plain(x.float(), H, W, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def _k1_case(gen, B, N, C, heads, Nkv):
    hd = C // heads
    return _rnd(gen, B, N, C), (
        1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), _rnd(gen, C, C, std=C ** -0.5),
        _rnd(gen, C, std=0.1), _rnd(gen, B, Nkv, heads, hd), _rnd(gen, B, Nkv, heads, hd),
        _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.1))


# every (C, heads) of b0 and b2; one key, a ragged key chunk, b0's 2040 keys; N below one
# 128-row tile at B = 1, a ragged second tile at B = 2
@pytest.mark.parametrize("C,heads", [(32, 1), (64, 2), (160, 5), (256, 8), (64, 1), (128, 2),
                                     (320, 5), (512, 8)])
@pytest.mark.parametrize("Nkv", [1, 65, 2040])
@pytest.mark.parametrize("B,H,W", [(1, 7, 9), (2, 10, 13)])
def test_k1_detector_widths_match_plain(gen, C, heads, Nkv, B, H, W):
    x, args = _k1_case(gen, B, H * W, C, heads, Nkv)
    before = fused_attention_block.launches
    got = fused_attention_block(x, H, W, heads, *args)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    want = attention_block_plain(x.float(), heads, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def _k2_case(gen, B, H, W, C):
    HID = 4 * C
    return _rnd(gen, B, H * W, C), (
        1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1), _rnd(gen, C, HID, std=C ** -0.5),
        _rnd(gen, HID, std=0.1), _rnd(gen, 3, 3, HID, std=1 / 3), _rnd(gen, HID, std=0.1),
        _rnd(gen, HID, C, std=HID ** -0.5), _rnd(gen, C, std=0.1))


_K2_PLANS = [(C, "fused") for C in k2.FUSED_WIDTHS] + [(C, "split") for C in k2.WIDTHS]


# every instantiated (width, route), through the C entry with that plan; H and W ragged
# for all three tile widths (and one pixel)
@pytest.mark.parametrize("C,route", _K2_PLANS)
@pytest.mark.parametrize("B,H,W", [(2, 13, 19), (1, 9, 50), (1, 1, 1)])
def test_k2_every_plan_matches_plain(gen, C, route, B, H, W):
    x, args = _k2_case(gen, B, H, W, C)
    ops, plan = k2._operands(x, H, W, *args)
    plan = k2.ffn_plan(B, H, W, C, 4 * C, route)
    got = k2.run_kernel(k2._lib(), "uttk_fused_ffn", (), ops, plan, H, W, 1e-6, "fused_ln_ffn")
    torch.cuda.synchronize()
    want = ln_ffn_plain(x.float(), H, W, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


def test_launch_plans_use_the_c_shared_memory_formulas(gen):
    """The plans' shared memory (Python) equals what the C side computes and checks."""
    import ctypes

    lib = k2._lib()
    lib.uttk_fused_ffn_smem.argtypes = [ctypes.c_int] * 4
    lib.uttk_fused_ffn_smem.restype = ctypes.c_longlong
    for C in k2.FUSED_WIDTHS:
        for tw in k2.TILE_WIDTHS:
            assert lib.uttk_fused_ffn_smem(C, 1, tw, 0) == k2.tile_smem(C, tw)
            assert lib.uttk_fused_ffn_smem(C, 0, tw, 0) == k2.stencil_smem(tw)
    plan = k2.ffn_plan(4, 28, 50, 512, 2048)
    assert lib.uttk_fused_ffn_smem(0, 0, 0, 1) == plan.gemm_smem
    lib1 = fa._lib()
    lib1.uttk_fused_attention_smem.argtypes = [ctypes.c_int]
    lib1.uttk_fused_attention_smem.restype = ctypes.c_longlong
    for C, heads in [(16, 1), (64, 2), (96, 2), (256, 4)]:
        plan = fa.attention_plan(2, 300, C, heads)
        assert lib1.uttk_fused_attention_smem(C // heads) == plan["attention_smem"]
        if heads > 1:
            assert lib1.uttk_fused_attention_smem(0) == plan["proj_smem"]


@pytest.mark.parametrize("mode", probe_attn.MODES)
@pytest.mark.parametrize("B,H,W,C,heads,Nkv", [(2, 9, 17, 128, 2, 77), (1, 5, 30, 512, 8, 130)])
def test_attention_probe_modes_match_plain(gen, mode, B, H, W, C, heads, Nkv):
    x, args = _k1_case(gen, B, H * W, C, heads, Nkv)
    before = probe_attn.attention_probe.launches
    got = probe_attn.attention_probe(mode, x, H, W, heads, *args)
    torch.cuda.synchronize()
    assert probe_attn.attention_probe.launches == before + (mode != "full")
    want = probe_attn.attention_probe_plain(mode, x.float(), heads, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", probe_ffn.MODES)
@pytest.mark.parametrize("B,H,W,C", [(2, 19, 13, 64), (1, 17, 10, 128), (1, 9, 21, 320),
                                     (2, 6, 50, 512)])
def test_ffn_probe_modes_match_plain(gen, mode, B, H, W, C):
    x, args = _k2_case(gen, B, H, W, C)
    before = probe_ffn.ffn_probe.launches
    got = probe_ffn.ffn_probe(mode, x, H, W, *args)
    torch.cuda.synchronize()
    assert probe_ffn.ffn_probe.launches == before + (mode != "full")
    want = probe_ffn.ffn_probe_plain(mode, x.float(), H, W, *[a.float() for a in args])
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)


# (B, Nq, Nkv, heads, hd, scale): ragged Nq and Nkv, one key, one query, many chunks; a
# negative and a zero scale (the wrapper hands the kernel a positive one)
@pytest.mark.parametrize("B,Nq,Nkv,heads,hd,scale", [
    (2, 100, 70, 2, 32, None), (1, 300, 1400, 1, 64, None), (2, 129, 65, 5, 64, 0.3),
    (1, 64, 1, 8, 64, None), (1, 1, 130, 1, 32, None), (1, 257, 2040, 1, 32, None),
    (2, 70, 130, 2, 32, -0.25), (1, 40, 65, 1, 64, 0.0),
])
def test_k3_kernel_matches_plain(gen, B, Nq, Nkv, heads, hd, scale):
    q, k, v = (_rnd(gen, B, n, heads, hd) for n in (Nq, Nkv, Nkv))
    before = flash_cross_attention.launches
    got = flash_cross_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_cross_attention.launches == before + 1
    want = cross_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (got.float() - want).abs()
    limit = k3_limit(q, k, v, want, scale)
    assert bool((err <= limit).all()), f"max err / limit {(err / limit).max().item():.3g}"


# Nkv around K3's 128-key chunk and its ring (a chunk x the ring depth + 1 reuses the
# first stage), b0's 2040; Nq not a multiple of the block's 128 rows
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("Nkv", [1, 63, 64, 65, k3.CHUNK * k3.STAGES + 1, 2040])
def test_k3_ring_and_tails_match_plain(gen, hd, Nkv):
    B, Nq, heads = 2, 300, 3
    q, k, v = (_rnd(gen, B, n, heads, hd) for n in (Nq, Nkv, Nkv))
    got = flash_cross_attention(q, k, v)
    torch.cuda.synchronize()
    want = cross_attention_plain(q.float(), k.float(), v.float())
    err = (got.float() - want).abs()
    limit = k3_limit(q, k, v, want)
    assert bool((err <= limit).all()), f"max err / limit {(err / limit).max().item():.3g}"


def test_k3_rejects_float32_and_other_head_dims(gen):
    q = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError):
        flash_cross_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_cross_attention(q, q, q)


def _conv_case(gen, ks, B, H, W, Ci, Co, bias, res):
    x = _rnd(gen, B, H, W, Ci)
    w = _rnd(gen, *((3, 3) if ks == 3 else ()), Ci, Co, std=(ks * ks * Ci) ** -0.5)
    b = _rnd(gen, Co, std=0.1) if bias else None
    r = _rnd(gen, B, H, W, Co) if res else None
    return x, w, b, r


# (B, H, W, Ci, Co, bias, residual, relu): stems, block convs, heads; H and W ragged
@pytest.mark.parametrize("B,H,W,Ci,Co,bias,res,relu", [
    (2, 13, 37, 9, 64, True, False, True), (1, 17, 19, 3, 64, True, False, True),
    (2, 11, 45, 16, 16, True, True, True), (1, 9, 35, 16, 16, False, False, False),
    (1, 10, 18, 32, 32, True, True, True), (2, 7, 21, 64, 64, True, False, True),
    (1, 12, 17, 128, 16, True, False, True), (1, 5, 23, 128, 128, True, True, True),
])
def test_k5a_kernel_matches_plain(gen, B, H, W, Ci, Co, bias, res, relu):
    x, w, b, r = _conv_case(gen, 3, B, H, W, Ci, Co, bias, res)
    before = conv3x3_bias_act.launches
    got = conv3x3_bias_act(x, w, b, r, relu=relu)
    packed = conv3x3_bias_act(x, pack(w, b), None, r, relu=relu)
    torch.cuda.synchronize()
    assert conv3x3_bias_act.launches == before + 2
    want = conv3x3_bias_act_plain(x.float(), w.float(), None if b is None else b.float(),
                                  None if r is None else r.float(), relu=relu)
    torch.testing.assert_close(got.float(), want, atol=K5_ATOL, rtol=K5_RTOL)
    assert torch.equal(got, packed)


# every K5a instantiation along its plan (its route, channel groups, tile and ring), H and
# W not multiples of the tile and more tiles than one block's ring holds, with and
# without the residual
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("Ci,Co", k5.CONV3_SHAPES)
def test_k5a_every_plan_matches_plain(gen, Ci, Co, res):
    plan = k5.conv_plan(3, Ci, Co)
    B, H, W = 2, 3 * plan.th + 5, 2 * plan.tw + 7
    x, w, b, r = _conv_case(gen, 3, B, H, W, Ci, Co, True, res)
    got = conv3x3_bias_act(x, w, b, r, relu=True)
    torch.cuda.synchronize()
    want = conv3x3_bias_act_plain(x.float(), w.float(), b.float(),
                                  None if r is None else r.float(), relu=True)
    torch.testing.assert_close(got.float(), want, atol=K5_ATOL, rtol=K5_RTOL)


def test_conv_plans_use_the_c_shared_memory_formulas(gen):
    """K5's plans' shared memory (Python) equals the C side's for the plan's instantiation."""
    import ctypes

    lib = k5._lib()
    lib.uttk_fused_conv_smem.argtypes = [ctypes.c_int] * 7
    lib.uttk_fused_conv_smem.restype = ctypes.c_longlong
    convs = [(3, ci, co) for ci, co in k5.CONV3_SHAPES] + [
        (1, ci, co) for ci, co in k5.CONV1_TILES] + [(1, 16, 3), (1, 16, 13)]
    for ks, ci, co in convs:
        plan = k5.conv_plan(ks, ci, co)
        assert lib.uttk_fused_conv_smem(ks, ci, co, plan.nb, plan.th, plan.tw,
                                        plan.depth) == plan.smem, (ks, ci, co)


@pytest.mark.parametrize("B,H,W,Ci,Co,bias,res,relu", [
    (2, 9, 37, 16, 3, True, False, False), (1, 11, 33, 16, 13, True, False, False),
    (1, 13, 18, 64, 32, True, False, True), (2, 7, 20, 64, 128, True, False, False),
    (1, 10, 17, 32, 128, True, True, True), (1, 6, 41, 32, 16, False, False, False),
    (1, 5, 9, 128, 64, True, False, False), (1, 8, 12, 128, 32, True, True, True),
])
def test_k5b_kernel_matches_plain(gen, B, H, W, Ci, Co, bias, res, relu):
    x, w, b, r = _conv_case(gen, 1, B, H, W, Ci, Co, bias, res)
    before = conv1x1_bias_act.launches
    got = conv1x1_bias_act(x, w, b, r, relu=relu)
    torch.cuda.synchronize()
    assert conv1x1_bias_act.launches == before + 1
    want = conv1x1_bias_act_plain(x.float(), w.float(), None if b is None else b.float(),
                                  None if r is None else r.float(), relu=relu)
    torch.testing.assert_close(got.float(), want, atol=K5_ATOL, rtol=K5_RTOL)


def test_k5_rejects_shape_without_instantiation(gen):
    x = torch.zeros(1, 4, 4, 48, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 48, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="instantiation"):
        conv3x3_bias_act(x, w)


def test_kernels_reject_float32(gen):
    xc = torch.zeros(1, 4, 4, 16, device="cuda")
    with pytest.raises(TypeError):
        conv3x3_bias_act(xc, torch.zeros(3, 3, 16, 16, device="cuda"))
    with pytest.raises(TypeError):
        conv1x1_bias_act(xc, torch.zeros(16, 16, device="cuda"))
    C, HID = 64, 256
    x = torch.zeros(1, 4, C, device="cuda")
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    with pytest.raises(TypeError):
        fused_ln_ffn(x, 2, 2, z(C), z(C), z(C, HID), z(HID), z(3, 3, HID), z(HID), z(HID, C), z(C))
    with pytest.raises(TypeError):
        fused_attention_block(x, 2, 2, 1, z(C), z(C), z(C, C), z(C), z(1, 4, 1, C), z(1, 4, 1, C),
                              z(C, C), z(C))


def test_k2_rejects_width_without_instantiation(gen):
    C, HID = 48, 192
    x = torch.zeros(1, 4, C, device="cuda", dtype=torch.bfloat16)
    z = lambda *s: torch.zeros(*s, device="cuda", dtype=torch.bfloat16)  # noqa: E731
    with pytest.raises(ValueError, match="instantiation"):
        fused_ln_ffn(x, 2, 2, z(C), z(C), z(C, HID), z(HID), z(3, 3, HID), z(HID), z(HID, C), z(C))


def _nms_dets(gen, n):
    """Seeded boxes as tests/test_nms.py makes them: (n, 5) f32 (x1, y1, x2, y2, score)."""
    u = torch.rand(n, 5, generator=gen, device="cuda")
    x1, y1 = 800 * u[:, 0], 500 * u[:, 1]
    w, h = 10 + 190 * u[:, 2], 10 + 190 * u[:, 3]
    return torch.stack([x1, y1, x1 + w, y1 + h, u[:, 4]], 1)


def _planted_dets():
    """IoU exactly 0.5, 0.3 and 0.7 in f32, identical boxes, tied scores, no overlap."""
    return torch.tensor([
        [0, 0, 9, 9, 0.9], [0, 0, 9, 4, 0.8], [100, 0, 109, 9, 0.9], [100, 0, 109, 2, 0.7],
        [200, 0, 209, 9, 0.6], [200, 0, 209, 6, 0.6], [300, 300, 350, 350, 0.5],
        [300, 300, 350, 350, 0.5], [300, 300, 350, 350, 0.4], [500, 500, 510, 510, 0.5],
        [600, 600, 610, 610, 0.5], [700, 0, 720, 20, 0.5]], device="cuda")


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, "planted"])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_k6_kernel_matches_plain(gen, n, thresh):
    dets = _planted_dets() if n == "planted" else _nms_dets(gen, n)
    order = k6.score_order(dets)
    boxes = dets[order, :4].contiguous()
    before = (k6.overlap_words.launches, k6.resolve_words.launches)
    words = k6.overlap_words(boxes, thresh)
    keep = k6.resolve_words(words, order)
    torch.cuda.synchronize()
    assert (k6.overlap_words.launches, k6.resolve_words.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert torch.equal(words, k6.overlap_words_plain(boxes, thresh))
    assert torch.equal(keep, k6.resolve_plain(words, order))
    assert torch.equal(k6.nms_mask(dets, thresh), keep)
    assert torch.equal(keep.cpu(), k6.nms_mask(dets.cpu(), thresh))


def test_k6_rejects_bfloat16_boxes(gen):
    dets = _nms_dets(gen, 10)
    with pytest.raises(TypeError):
        k6.nms_mask(dets.to(torch.bfloat16), 0.5)


@pytest.mark.parametrize("n", [78_592, "max", "over"])
def test_k6_resolve_limit(gen, n):
    """The resolve takes every N up to uttk_nms_max_boxes() (its `removed` words fill its
    shared memory): 78,592 boxes, the limit itself, and one box more is refused. The
    boxes come in identical pairs with tied scores on a grid where no pairs overlap, so
    the first box of each pair is kept and row 2k holds the single bit 2k + 1."""
    limit = k6._lib().uttk_nms_max_boxes()
    if n == "over":
        with pytest.raises(ValueError, match="at most"):
            k6.overlap_words(torch.zeros(limit + 1, 4, device="cuda"), 0.5)
        return
    n = limit if n == "max" else n
    p = torch.arange(n, device="cuda") // 2
    x, y = (p % 512 * 20).float(), (p // 512 * 20).float()
    dets = torch.stack([x, y, x + 9, y + 9, torch.ones_like(x)], 1)
    order = k6.score_order(dets)
    words = k6.overlap_words(dets[order, :4].contiguous(), 0.5)
    keep = k6.resolve_words(words, order)
    rows = torch.arange(0, n - 1, 2, device="cuda")
    want = torch.zeros_like(words)
    want[rows, (rows + 1) // 64] = 1 << ((rows + 1) % 64)
    assert torch.equal(order, torch.arange(n, device="cuda"))
    assert torch.equal(words, want)
    assert torch.equal(keep, torch.arange(n, device="cuda") % 2 == 0)


# b2's four hidden shapes at 1600x896, batch 4 (the trainer's), and ragged ones: H and W
# not multiples of the 8-column tile or the plan's rows, C not a multiple of the
# forward's 64-channel or the backward's 32-channel group
@pytest.mark.parametrize("B,H,W,C", [
    (4, 224, 400, 256), (4, 112, 200, 512), (4, 56, 100, 1280), (4, 28, 50, 2048),
    (2, 9, 37, 64), (1, 17, 33, 8), (2, 3, 5, 136), (1, 1, 1, 16),
])
def test_k4_kernel_matches_plain(gen, B, H, W, C):
    x = _rnd(gen, B, H, W, C).requires_grad_()
    w, b = _rnd(gen, 3, 3, C, std=1 / 3).requires_grad_(), _rnd(gen, C, std=0.1).requires_grad_()
    g = _rnd(gen, B, H, W, C)
    before = (depthwise_conv3x3.launches, dwconv3x3_backward.launches)
    got = depthwise_conv3x3(x, w, b)
    got.backward(g)  # the backward kernel: dx (g with the flipped taps), dw and db
    torch.cuda.synchronize()
    # one forward launch; the backward's fused pass and the sum of its partials
    assert (depthwise_conv3x3.launches, dwconv3x3_backward.launches) == (before[0] + 1,
                                                                         before[1] + 2)
    want = dwconv3x3_plain(x.detach().float(), w.detach().float(), b.detach().float())
    torch.testing.assert_close(got.detach().float(), want, atol=K5_ATOL, rtol=K5_RTOL)
    dx, dw, db = dwconv3x3_backward_plain(x.detach().float(), w.detach().float(), g.float())
    torch.testing.assert_close(x.grad.float(), dx, atol=K5_ATOL, rtol=K5_RTOL)
    for got_sum, want_sum in ((w.grad, dw), (b.grad, db)):
        assert got_sum.dtype == torch.bfloat16
        limit = K4_SUM_ATOL * want_sum.abs().max() + K4_SUM_RTOL * want_sum.abs()
        assert bool(((got_sum.float() - want_sum).abs() <= limit).all())


@pytest.mark.parametrize("B,H,W,C", [(4, 56, 100, 1280), (2, 45, 77, 136)])
def test_k4_backward_repeats_bit_for_bit(gen, B, H, W, C):
    """No float atomics: dw and db (the f32 sums, before their rounding) and dx of two
    calls on the same inputs are equal bit for bit."""
    x, w, g = _rnd(gen, B, H, W, C), _rnd(gen, 3, 3, C, std=1 / 3), _rnd(gen, B, H, W, C)
    first, second = (k4._launch_backward(x, k4._dx_taps(w), g) for _ in range(2))
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    assert first[1].dtype == first[2].dtype == torch.float32


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_k4_refuses_a_plan_for_other_tiles(gen, backward):
    """The C launchers check the host plan against their own tiles: the plan runs, and a
    plan one tile short in any axis is refused before anything is launched."""
    B, H, W, C = 2, 45, 77, 136
    x = _rnd(gen, B, H, W, C)
    plan = k4.dwconv_plan(B, H, W, C, backward)
    out, sums = torch.empty_like(x), torch.empty(k4.PARTS, C, device="cuda")
    scratch = torch.empty(max(plan.partials, 1), k4.PARTS, C, device="cuda")
    lib, stream = k4._lib(), torch.cuda.current_stream().cuda_stream

    def launch(rows, tiles_w, tiles_h, groups, partials):
        if backward:
            return lib.uttk_dwconv3x3_backward(
                x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                sums.data_ptr(), B, H, W, C, rows, tiles_w, tiles_h, groups, partials, stream)
        return lib.uttk_dwconv3x3(x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  B, H, W, C, rows, tiles_w, tiles_h, groups, stream)

    assert launch(*plan) == 0
    torch.cuda.synchronize()
    for axis in range(1, 4):
        short = list(plan)
        short[axis] -= 1
        assert launch(*short) != 0, plan._fields[axis]


def test_k4_rejects_channels_not_multiple_of_8(gen):
    x = torch.zeros(1, 4, 4, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        depthwise_conv3x3(x, x[0, :3, :3], x[0, 0, 0])


def _grads_close(kernel_fn, plain_fn, inputs):
    """Gradients of every input: the kernel path on bf16 leaves against the plain version
    on f32 copies of the same values, one bf16 cotangent."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    ref = [t.float().requires_grad_() for t in inputs]
    out = kernel_fn(*leaves)
    g = torch.randn(out.shape, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(plain_fn(*ref), ref, g.float())
    for i, (a, b) in enumerate(zip(got, want)):
        rel = ((a.float() - b).norm() / b.norm()).item()
        assert rel <= GRAD_REL, f"input {i}: relative error {rel:.3g}"


@pytest.mark.parametrize("B,H,W,C,heads,Nkv", [(2, 14, 25, 64, 1, 40), (2, 7, 13, 320, 5, 91)])
def test_k1_k2_gradients_match_plain(gen, B, H, W, C, heads, Nkv):
    HID, hd = 4 * C, C // heads
    ffn = [_rnd(gen, B, H * W, C), 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
           _rnd(gen, C, HID, std=C ** -0.5), _rnd(gen, HID, std=0.1),
           _rnd(gen, 3, 3, HID, std=1 / 3), _rnd(gen, HID, std=0.1),
           _rnd(gen, HID, C, std=HID ** -0.5), _rnd(gen, C, std=0.1)]
    counts = (fused_ln_ffn, depthwise_conv3x3, dwconv3x3_backward)
    before = [f.launches for f in counts]
    _grads_close(lambda x, *p: fused_ln_ffn(x, H, W, *p),
                 lambda x, *p: ln_ffn_plain(x, H, W, *p), ffn)
    # K2 forward once; its recompute backward runs K4's forward once and K4's backward once
    # (two launches: the fused pass and the sum of its partials)
    assert [f.launches - n for f, n in zip(counts, before)] == [1, 1, 2]
    attn = [_rnd(gen, B, H * W, C), 1 + _rnd(gen, C, std=0.1), _rnd(gen, C, std=0.1),
            _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.1), _rnd(gen, B, Nkv, heads, hd),
            _rnd(gen, B, Nkv, heads, hd), _rnd(gen, C, C, std=C ** -0.5), _rnd(gen, C, std=0.1)]
    _grads_close(lambda x, *p: fused_attention_block(x, H, W, heads, *p),
                 lambda x, *p: attention_block_plain(x, heads, *p), attn)


def test_k3_gradients_match_plain(gen):
    q, k, v = (_rnd(gen, 2, n, 2, 64) for n in (300, 77, 77))
    before = flash_cross_attention.launches
    _grads_close(flash_cross_attention, cross_attention_plain, [q, k, v])
    assert flash_cross_attention.launches == before + 1


def test_b2_backward_gives_every_parameter_a_gradient(gen):
    torch.manual_seed(0)
    net = SegFormerNet(1, 3, "b2", train=True).cuda()
    x = torch.randn(2, 256, 448, 9, device="cuda", generator=gen).to(torch.bfloat16)
    net(x)[0].float().square().mean().backward()
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_k5_raises_under_grad(gen):
    x = _rnd(gen, 1, 6, 9, 16)
    w = _rnd(gen, 3, 3, 16, 16, std=0.1).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3_bias_act(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        conv1x1_bias_act(x, w[0, 0])
    with torch.no_grad():
        conv3x3_bias_act(x, w)


# --- S1, the integrator (ops/csrc/physics.cu) -------------------------------------------
# Held as chip_smoke.py's physics phase holds it, per trajectory over the whole run:
# |dr| <= 1e-4 m, |dv| <= 1e-3 m/s, |dw| <= 1e-2 rad/s, dr/dq within 1e-3 of the
# trajectory's largest |dr/dq|; the kernel and the plain version run the same float32
# operations in the same order, so every output is also bit-equal, as the physics phase
# gates it at its two shapes. The plain version runs as one captured step replayed
# (`graph=True`), which the eager loop holds bit for bit below. The autograd Function's
# gradient against autograd through the plain version: 1e-5 relative in norm (reverse
# mode sums in another order than the tangent's contraction).
S1_ATOL = (1e-4, 1e-3, 1e-2)
S1_JAC_RTOL = 1e-3


def _s1_states(n, direction="left_to_right"):
    from upliftingtabletennis_torch.data import datagen as DG

    return DG.sample_initial_conditions(n, "intermediate", direction,
                                        torch.Generator(device="cuda").manual_seed(n), "cuda")


# the main path's shapes, ragged n (one thread, one warp and one past, one block past),
# substeps 0 (every frame the same state), 1 and 3, first_step off, and frame counts of
# 1, 2 and odd ones
S1_FORWARD_CASES = [(8192, 500, 2, True), (1, 500, 2, True), (33, 37, 2, False),
                    (513, 61, 1, True), (33, 7, 0, True), (33, 7, 0, False), (1, 1, 3, False),
                    (65, 2, 3, True), (513, 40, 3, False)]
S1_TANGENT_CASES = [(32, 502, 2, True), (3, 20, 2, True), (1, 33, 0, False), (33, 61, 1, True),
                    (513, 40, 3, False), (11, 1, 2, False)]


@pytest.mark.parametrize("n,frames,substeps,first_step", S1_FORWARD_CASES)
def test_s1_forward_matches_plain(gen, n, frames, substeps, first_step):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import physics as S1

    s0 = _s1_states(n)
    before = S1.simulate.launches
    got = S1.simulate(s0, frames, substeps, first_step=first_step)
    torch.cuda.synchronize()
    assert S1.simulate.launches == before + 1
    want = P.simulate(s0, frames, substeps, first_step=first_step, graph=True)
    over = torch.zeros(n, dtype=torch.bool, device="cuda")
    for g, w, tol in zip(got, want, S1_ATOL):
        assert g.shape == (frames, n, 3)
        over |= ~((g - w).abs().amax(dim=(0, 2)) <= tol)
    assert int(over.sum()) == 0
    for g, w in zip(got, want):  # the same operations in the same order: bit for bit
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,frames,substeps,first_step", S1_TANGENT_CASES)
def test_s1_tangent_matches_plain(gen, n, frames, substeps, first_step):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import physics as S1

    s0 = _s1_states(n, "right_to_left")
    args = (frames, substeps, P.DT, 10.0, 100.0, first_step)
    got_r, got_j = S1.simulate_tangent(s0, *args)
    torch.cuda.synchronize()
    want_r, want_j = P.simulate_tangent(s0, *args, graph=True)
    assert got_j.shape == (frames, n, 3, 9)
    r_err = (got_r - want_r).abs().amax(dim=(0, 2))
    j_err = (got_j - want_j).abs().amax(dim=(0, 2, 3))
    ok = (r_err <= S1_ATOL[0]) & (j_err <= S1_JAC_RTOL * want_j.abs().amax(dim=(0, 2, 3)))
    assert int((~ok).sum()) == 0
    assert torch.equal(got_r, want_r) and torch.equal(got_j, want_j)
    # the forward mode's positions are the same arithmetic
    np_r = S1.simulate(s0, frames, substeps, first_step=first_step).r
    assert torch.equal(np_r, got_r)


@pytest.mark.parametrize("mode,n,frames,substeps,first_step", [
    ("forward", 513, 61, 1, True), ("forward", 8192, 40, 2, True), ("forward", 33, 7, 0, False),
    ("tangent", 33, 61, 1, True), ("tangent", 32, 40, 2, False)])
def test_s1_plain_graph_replay_matches_the_eager_plain(gen, mode, n, frames, substeps,
                                                        first_step):
    from upliftingtabletennis_torch.core import physics as P

    s0 = _s1_states(n)
    if mode == "forward":
        def run(graph):
            return P.simulate(s0, frames, substeps, first_step=first_step, graph=graph)
    else:
        def run(graph):
            return P.simulate_tangent(s0, frames, substeps, P.DT, 10.0, 100.0, first_step,
                                      graph=graph)
    eager, replayed = run(False), run(True)
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)


def test_s1_backward_matches_autograd_through_plain(gen):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import physics as S1

    s0 = _s1_states(32)
    q = torch.cat([s0.r, s0.v / 10.0, s0.w / 100.0], -1).requires_grad_(True)
    pos = S1.trajectory_positions(q, 40, 2, v_scale=10.0, w_scale=100.0)
    cot = torch.randn(pos.shape, generator=gen, device="cuda")
    (g_kernel,) = torch.autograd.grad((pos * cot).sum(), q)
    ref = P.simulate(S1.params_to_state(q, 10.0, 100.0), 40).r
    (g_plain,) = torch.autograd.grad((ref * cot).sum(), q)
    assert torch.equal(pos.detach(), ref.detach())
    assert float((g_kernel - g_plain).norm() / g_plain.norm()) < 1e-5


def test_s1_constants_and_refusals(gen):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import physics as S1

    assert S1.kernel_const_names() == list(P.KERNEL_CONSTANTS)
    s0 = _s1_states(4)
    with pytest.raises(TypeError, match="float32"):
        S1.simulate(P.BallState(*(x.double() for x in s0)), 4)
    with pytest.raises(ValueError, match="shape"):
        S1.simulate(P.BallState(s0.r, s0.v[:2], s0.w), 4)
