"""The phase probes of K1 and K2 (`upliftingtabletennis_torch/tools/probe_*_phases.py`) and
the launch plans of the two kernels, on the CPU.

- Each plain probe mode against a numpy transcription of the JAX probe's mode, written
  from `tools/probe_attn_phases.py` (`variant_kernel`, lines 37-78) and
  `tools/probe_ffn_phases.py` (`variant_kernel`, lines 41-80): f32 throughout, where the
  port's casts to x.dtype are no-ops; tolerance 1e-4 (the f32 sums' order).
- Mode `full` equal bit for bit to `attention_block_plain` / `ln_ffn_plain`.
- Every other mode differs from `full` beyond K1/K2's limit (6e-2 + 2e-2 |full|), on
  inputs where each phase matters (x with a mean of 0.5 and a spread of 2, so LN(x) is
  not x; keys of std 2, so the softmax is not flat).
- The plans (`attention_plan`, `ffn_plan`) at every b0/b2 width at its detector shape
  (b2 at 1600x896, b0 at 1920x1088): every output row or pixel and column covered once
  by the blocks, as the kernels map block indices to tiles; shared memory within the
  232,448 bytes a block may use, by the C side's formulas; and at every b2 stage at
  batch 4, at least 132 blocks (one per SM) in each pass a plan launches.
"""
import numpy as np
import pytest
import torch
from scipy.special import erf

from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops.fused_attention import attention_block_plain, attention_plan
from upliftingtabletennis_torch.ops.fused_ffn import FUSED_WIDTHS, WIDTHS, ffn_plan, ln_ffn_plain
from upliftingtabletennis_torch.tools.probe_attn_phases import MODES as ATTN_MODES
from upliftingtabletennis_torch.tools.probe_attn_phases import attention_probe_plain
from upliftingtabletennis_torch.tools.probe_ffn_phases import MODES as FFN_MODES
from upliftingtabletennis_torch.tools.probe_ffn_phases import ffn_probe_plain

torch.set_num_threads(1)
ATOL, RTOL = 6e-2, 2e-2
EPS = 1e-6
SMS = 132  # streaming multiprocessors of an H100 SXM
# (H, W, C, heads, Nkv) of every stage: segformerpp_b2 at 1600x896, segformerpp_b0 at 1920x1088
B2 = [(224, 400, 64, 1, 1400), (112, 200, 128, 2, 1400), (56, 100, 320, 5, 1400),
      (28, 50, 512, 8, 1400)]
B0 = [(272, 480, 32, 1, 2040), (136, 240, 64, 2, 2040), (68, 120, 160, 5, 2040),
      (34, 60, 256, 8, 2040)]


def _ln(x, gamma, beta):
    mean = x.mean(-1, keepdims=True)
    var = np.square(x - mean).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + EPS) * gamma + beta


def _attn_np(mode, x, heads, gamma, beta, wq, bq, k, v, wp, bp):
    """tools/probe_attn_phases.py `variant_kernel` per sample, k/v as (B, Nkv, heads, hd)."""
    C = x.shape[-1]
    hd = C // heads
    y = x if mode == "no_ln" else _ln(x, gamma, beta)
    q = y @ wq + bq
    outs = []
    for h in range(heads):
        qh, kh, vh = q[..., h * hd:(h + 1) * hd], k[:, :, h], v[:, :, h]
        logits = qh @ kh.transpose(0, 2, 1) * hd ** -0.5
        if mode == "no_softmax":
            w = logits * (1.0 / logits.shape[-1])
        else:
            e = np.exp(logits - logits.max(-1, keepdims=True))
            w = e / e.sum(-1, keepdims=True)
        outs.append(w @ vh)
    return x + np.concatenate(outs, -1) @ wp + bp


def _ffn_np(mode, x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2):
    """tools/probe_ffn_phases.py `variant_kernel` on the whole image: h is zero outside it."""
    B, _, C = x.shape
    HID = w1.shape[1]
    h = (_ln(x, gamma, beta) @ w1 + b1).reshape(B, H, W, HID)
    if mode in ("full", "no_gelu"):
        hp = np.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = sum(hp[:, dy:dy + H, dx:dx + W] * dw[dy, dx] for dy in range(3) for dx in range(3))
    else:
        acc = h * dw[1, 1]
    z = acc + bdw
    if mode in ("full", "no_dw"):
        z = 0.5 * z * (1.0 + erf(z * 0.7071067811865476))
    return x + z.reshape(B, H * W, HID) @ w2 + b2


def _attn_inputs(seed, B, N, C, heads, Nkv):
    rng = np.random.default_rng(seed)
    hd = C // heads
    f = lambda *s, m=0.0, sd=1.0: rng.normal(m, sd, s).astype(np.float32)  # noqa: E731
    return f(B, N, C, m=0.5, sd=2.0), [
        f(C, m=1.0, sd=0.1), f(C, sd=0.1), f(C, C, sd=C ** -0.5), f(C, sd=0.1),
        f(B, Nkv, heads, hd, sd=2.0), f(B, Nkv, heads, hd), f(C, C, sd=C ** -0.5), f(C, sd=0.1)]


def _ffn_inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    HID = 4 * C
    f = lambda *s, m=0.0, sd=1.0: rng.normal(m, sd, s).astype(np.float32)  # noqa: E731
    return f(B, H * W, C, m=0.5, sd=2.0), [
        f(C, m=1.0, sd=0.1), f(C, sd=0.1), f(C, HID, sd=C ** -0.5), f(HID, sd=0.1),
        f(3, 3, HID, sd=1 / 3), f(HID, sd=0.1), f(HID, C, sd=HID ** -0.5), f(C, sd=0.1)]


_T = lambda arrays: [torch.from_numpy(a) for a in arrays]  # noqa: E731


@pytest.mark.parametrize("mode", ATTN_MODES)
@pytest.mark.parametrize("B,N,C,heads,Nkv", [(2, 37, 32, 1, 23), (1, 20, 64, 2, 70),
                                             (1, 9, 48, 3, 5)])
def test_attention_probe_plain_matches_jax_probe(mode, B, N, C, heads, Nkv):
    x, p = _attn_inputs(0, B, N, C, heads, Nkv)
    got = attention_probe_plain(mode, torch.from_numpy(x), heads, *_T(p)).numpy()
    np.testing.assert_allclose(got, _attn_np(mode, x, heads, *p), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", FFN_MODES)
@pytest.mark.parametrize("B,H,W,C", [(2, 6, 9, 16), (1, 11, 7, 32), (1, 1, 5, 16)])
def test_ffn_probe_plain_matches_jax_probe(mode, B, H, W, C):
    x, p = _ffn_inputs(1, B, H, W, C)
    got = ffn_probe_plain(mode, torch.from_numpy(x), H, W, *_T(p)).numpy()
    np.testing.assert_allclose(got, _ffn_np(mode, x, H, W, *p), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_modes_equal_the_plain_kernels_bit_for_bit(dtype):
    x, p = _attn_inputs(2, 2, 30, 64, 2, 40)
    x, p = torch.from_numpy(x).to(dtype), [t.to(dtype) for t in _T(p)]
    assert torch.equal(attention_probe_plain("full", x, 2, *p), attention_block_plain(x, 2, *p))
    x, p = _ffn_inputs(3, 2, 5, 6, 32)
    x, p = torch.from_numpy(x).to(dtype), [t.to(dtype) for t in _T(p)]
    assert torch.equal(ffn_probe_plain("full", x, 5, 6, *p), ln_ffn_plain(x, 5, 6, *p))


def _differs(a, b):
    return not torch.allclose(a.float(), b.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ATTN_MODES[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_probe_modes_differ_from_full(mode, dtype):
    x, p = _attn_inputs(4, 2, 50, 64, 2, 90)
    x, p = torch.from_numpy(x).to(dtype), [t.to(dtype) for t in _T(p)]
    assert _differs(attention_probe_plain(mode, x, 2, *p), attention_probe_plain("full", x, 2, *p))


@pytest.mark.parametrize("mode", FFN_MODES[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_probe_modes_differ_from_full(mode, dtype):
    x, p = _ffn_inputs(5, 2, 7, 9, 32)
    x, p = torch.from_numpy(x).to(dtype), [t.to(dtype) for t in _T(p)]
    assert _differs(ffn_probe_plain(mode, x, 7, 9, *p), ffn_probe_plain("full", x, 7, 9, *p))


def test_probe_modes_reject_unknown_names():
    x, p = _attn_inputs(6, 1, 4, 32, 1, 3)
    with pytest.raises(ValueError, match="unknown mode"):
        attention_probe_plain("no_exp", torch.from_numpy(x), 1, *_T(p))
    x, p = _ffn_inputs(6, 1, 2, 2, 16)
    with pytest.raises(ValueError, match="unknown mode"):
        ffn_probe_plain("no_fc1", torch.from_numpy(x), 2, 2, *_T(p))


def _row_tiles_cover_once(n_rows, blocks, rows_per_block):
    counts = np.zeros(n_rows, np.int64)
    for bx in range(blocks):
        counts[bx * rows_per_block:min((bx + 1) * rows_per_block, n_rows)] += 1
    return bool((counts == 1).all())


def _col_tiles_cover_once(n_cols, blocks, cols_per_block):
    return _row_tiles_cover_once(n_cols, blocks, cols_per_block)


@pytest.mark.parametrize("H,W,C,heads,Nkv", B2 + B0)
def test_attention_plan_covers_rows_once_within_shared_memory(H, W, C, heads, Nkv):
    B, N = 4, H * W
    plan = attention_plan(B, N, C, heads)
    # attention_kernel: block (x, head, sample) owns rows [128 x, 128 x + 128) of (sample, head)
    gx, gh, gb = plan["attention_grid"]
    assert (gh, gb) == (heads, B)
    assert _row_tiles_cover_once(N, gx, plan["rows_per_block"])
    assert _row_tiles_cover_once(B * N, plan["ln_grid"][0], _build.LN_ROWS)
    assert max(plan["attention_smem"], plan["proj_smem"]) <= _build.SMEM_LIMIT
    grids = [plan["ln_grid"], plan["attention_grid"]]
    if heads == 1:  # the attention kernel applies the out-projection to its own rows
        assert plan["proj_grid"] == ()
    else:
        # out-projection: block (x, y) owns rows [128 x, ...) of the B*N rows, columns
        # [128 y, ...)
        px, py = plan["proj_grid"]
        assert _row_tiles_cover_once(B * N, px, _build.GEMM_TILE)
        assert _col_tiles_cover_once(C, py, _build.GEMM_TILE)
        grids.append(plan["proj_grid"])
    if (H, W, C, heads, Nkv) in B2:
        assert all(np.prod(g) >= SMS for g in grids)


def _pixels_cover_once(plan, H, W):
    """The tile kernel's mapping (fused_ffn.cuh tile_kernel): block x owns the pixels
    (r0 + p // TW, c0 + p % TW), p < 128, of the tile (x // tiles_x, x % tiles_x), those
    inside the image."""
    tiles_x = -(-W // plan.tw)
    counts = np.zeros((H, W), np.int64)
    p = np.arange(_build.BM)
    for bx in range(plan.grid[0]):
        r = (bx // tiles_x) * plan.th + p // plan.tw
        c = (bx % tiles_x) * plan.tw + p % plan.tw
        inside = (r < H) & (c < W)
        np.add.at(counts, (r[inside], c[inside]), 1)
    return bool((counts == 1).all())


# the plan's own route at every stage, and each instantiated route where it is not the
# plan's choice
_ROUTES = [(None, *s) for s in B2 + B0] + [
    (r, *s) for s in B2 + B0 for r, table in (("fused", FUSED_WIDTHS), ("split", WIDTHS))
    if s[2] in table]


@pytest.mark.parametrize("route,H,W,C,heads,Nkv", _ROUTES)
def test_ffn_plan_covers_pixels_once_within_shared_memory(route, H, W, C, heads, Nkv):
    B, HID = 4, 4 * C
    plan = ffn_plan(B, H, W, C, HID, route)
    assert plan.th * plan.tw == _build.BM
    # the tile kernel (fused) and the stencil kernel (split): block (x, y, sample) owns the
    # 128-pixel tile x, all C output columns (fused) or hidden channels [256 y, 256 y + 256)
    assert plan.grid[2] == B and _pixels_cover_once(plan, H, W)
    if plan.route == "fused":
        assert plan.grid[1] == 1
    else:
        assert _col_tiles_cover_once(HID, plan.grid[1], 4 * 64)
    assert plan.smem <= _build.SMEM_LIMIT
    grids = [plan.grid]
    if plan.route == "split":
        # LayerNorm: block x owns rows [32 x, 32 x + 32) of the B*H*W pixels; fc1 and fc2:
        # block (x, y) owns rows [128 x, ...) and columns [128 y, ...) of HID and of C
        assert _row_tiles_cover_once(B * H * W, plan.ln_grid[0], _build.LN_ROWS)
        for grid, cols in ((plan.fc1_grid, HID), (plan.fc2_grid, C)):
            assert _row_tiles_cover_once(B * H * W, grid[0], _build.GEMM_TILE)
            assert _col_tiles_cover_once(cols, grid[1], _build.GEMM_TILE)
        assert plan.gemm_smem <= _build.SMEM_LIMIT
        grids += [plan.ln_grid, plan.fc1_grid, plan.fc2_grid]
    if route is None and (H, W, C, heads, Nkv) in B2:
        assert all(np.prod(g) >= SMS for g in grids)


def test_ffn_plan_routes_and_rejects_widths_without_instantiation():
    assert ffn_plan(4, 224, 400, 64, 256).route == "fused"
    assert ffn_plan(4, 28, 50, 512, 2048).route == "split"
    with pytest.raises(ValueError, match="instantiation"):
        ffn_plan(1, 4, 4, 48, 192)
    with pytest.raises(ValueError, match="instantiation"):
        ffn_plan(1, 4, 4, 512, 2048, "fused")
    with pytest.raises(ValueError, match="HID % 64"):
        ffn_plan(1, 4, 4, 64, 96)
    with pytest.raises(ValueError, match="head dim"):
        attention_plan(1, 4, 96, 1)
