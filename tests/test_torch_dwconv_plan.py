"""K4's launch plans and its card limits, on the CPU (no JAX, no card).

Every K4 shape of chip_smoke.py's k4 phase (b2's four hidden shapes of the 1600x896
trainer at batch 4, and the ragged one) and some small ragged ones have forward and
backward plans (`dwconv_plan`) whose tiles cover the image once, whose grid fits the
launch limits, and whose backward scratch (one f32 partial of dw and db per block)
adds less than a tenth to the bytes the backward must move. K4's limits on the card
admit the bf16 rounding of the plain versions' outputs (forward and dx at 1e-2 + 8e-3
|plain|, dw and db at 1e-3 max |plain| + 2^-8 |plain|) and reject each planted fault
that the k4 phase simulates (`chip_smoke.k4_faults`).
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from upliftingtabletennis_torch.ops import dwconv as k4  # noqa: E402

torch.set_num_threads(1)
SHAPES = [s[:4] for s in chip_smoke.K4_SHAPES + [chip_smoke.K4_RAGGED]] + [
    (1, 1, 1, 8), (1, 3, 17, 16), (2, 9, 37, 64), (1, 200, 5, 8)]


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plans_cover_the_image_once(shape, backward):
    B, H, W, C = shape
    plan = k4.dwconv_plan(B, H, W, C, backward)
    assert 1 <= plan.rows <= H and (plan.rows >= k4.MIN_ROWS or plan.rows == H)
    assert (plan.tiles_h - 1) * plan.rows < H <= plan.tiles_h * plan.rows
    assert (plan.tiles_w - 1) * k4.TILE_W < W <= plan.tiles_w * k4.TILE_W
    cg = k4.TILE_C[backward]
    assert (plan.groups - 1) * cg < C <= plan.groups * cg
    assert plan.groups <= 65535 and B <= 65535  # grid y and z
    assert plan.partials == (B * plan.tiles_h * plan.tiles_w if backward else 0)


@pytest.mark.parametrize("shape", [s[:4] for s in chip_smoke.K4_SHAPES])
def test_b2_plans_fill_the_card_and_keep_the_scratch_small(shape):
    B, H, W, C = shape
    for backward in (False, True):
        plan = k4.dwconv_plan(B, H, W, C, backward)
        blocks = B * plan.tiles_h * plan.tiles_w * plan.groups
        assert blocks >= k4.TARGET_BLOCKS or plan.rows == k4.MIN_ROWS, (backward, plan)
        assert (plan.rows + 2) / plan.rows <= 1.25, (backward, plan)  # the halo rows
    plan = k4.dwconv_plan(B, H, W, C, backward=True)
    scratch = plan.partials * k4.PARTS * C * 4 * 2  # written once, read once
    # against g and x read and dx written: 0.7% at stage 1, 6.7% at stage 4 (28 x 8 tiles)
    assert scratch < 0.1 * 6 * B * H * W * C, plan


# the kernels' rounding (bf16 outputs of f32 sums), and the faults of the k4 phase: dx with
# the unflipped taps, the halo rows between the forward's row tiles dropped, one block's
# partial of dw and db left out, the halo columns at the backward's tile seams dropped
@pytest.mark.parametrize("shape", [(2, 45, 77, 136), (1, 28, 50, 64)])
def test_k4_limits_admit_bf16_rounding_and_reject_faults(shape):
    gen = torch.Generator().manual_seed(4)
    B, H, W, C = shape

    def rnd(*s, std=1.0):
        return (torch.randn(*s, generator=gen) * std).to(torch.bfloat16)

    x, w, b, g = rnd(B, H, W, C), rnd(3, 3, C, std=1 / 3), rnd(C, std=0.1), rnd(B, H, W, C)
    plans = (k4.dwconv_plan(B, H, W, C), k4.dwconv_plan(B, H, W, C, backward=True))
    want = k4.dwconv3x3_plain(x.float(), w.float(), b.float())
    dx, dw, db = k4.dwconv3x3_backward_plain(x.float(), w.float(), g.float())
    refs = {"out": want, "dx": dx, "dw": dw, "db": db}
    # the plain versions rounded to bf16, as the kernels round their outputs
    for name, ref in refs.items():
        if name in ("dw", "db"):
            assert chip_smoke.k4_sums_ok(torch, ref.to(torch.bfloat16), ref)[1], name
        else:
            assert chip_smoke.compare(torch, ref.to(torch.bfloat16), ref, chip_smoke.K5_ATOL,
                                      chip_smoke.K5_RTOL)[2], name
    faults = chip_smoke.k4_faults(torch, x, w, b, g, plans)
    assert set(faults) == {"unflipped_dx", "halo_rows_dropped", "partial_left_out_dw",
                           "partial_left_out_db", "halo_column_dropped_dw"}
    for name, (bad, what) in faults.items():
        if what in ("dw", "db"):
            err, ok = chip_smoke.k4_sums_ok(torch, bad, refs[what])
        else:
            ok = chip_smoke.compare(torch, bad, refs[what], chip_smoke.K5_ATOL,
                                    chip_smoke.K5_RTOL)[2]
        assert not ok, name
