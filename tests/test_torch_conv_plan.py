"""K5's launch plans and its card limit, on the CPU (no JAX, no card).

Every stride-1 conv of both HRNets (WASB and the table HRNet at 1280x704, recorded on
the meta device by `chip_smoke.hrnet_conv_shapes`) has a plan (`conv_plan`) whose
block fits in the 232,448 bytes of shared memory a block may use on sm_90, and whose
TMA tensor maps (built as fused_conv.cu `launch3` builds them) are legal: box
dimensions of at most 256 elements, global strides that are multiples of 16 bytes.
K5's limit on the card (|kernel - plain| <= 1e-2 + 8e-3 |plain|) admits the bf16
rounding of the plain version's output and rejects the planted faults that
chip_smoke.py's k5 phase simulates (`k5_faults`).
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from upliftingtabletennis_torch.ops import _build  # noqa: E402
from upliftingtabletennis_torch.ops import fused_conv as k5  # noqa: E402

torch.set_num_threads(1)
BATCH = chip_smoke.HR_CHUNK


def _maps(plan, H, W, ci, co):
    """(dims, byte strides, box) of the tensor maps of a K5a launch (fused_conv.cu
    `launch3`): the input (none for a stem), and the residual and the output."""
    maps = {}
    if plan.route == "tma":
        maps["x"] = ((ci, W, H, BATCH), (2 * ci, 2 * ci * W, 2 * ci * W * H),
                     (min(ci, 64), plan.tw + 2, plan.th + 2, 1))
    maps["out"] = ((co, W, H, BATCH), (2 * co, 2 * co * W, 2 * co * W * H),
                   (plan.nb, plan.tw, plan.th // 2, 1))
    return maps


def test_every_hrnet_conv_has_a_legal_plan():
    shapes = chip_smoke.hrnet_conv_shapes(torch)
    assert sum(n[0] for k, n in shapes.items() if k[0] == 3) == chip_smoke.K5A_PER_FORWARD
    for ks, ci, co, H, W, _, _ in shapes:
        plan = k5.conv_plan(ks, ci, co)
        assert plan.smem <= _build.SMEM_LIMIT, (ks, ci, co, plan)
        if ks == 1:
            assert plan.route == "mma"
            continue
        assert plan.route == ("stem" if ci < 16 else "tma")
        assert co % plan.nb == 0 and plan.nb in (16, 32, 64)
        assert plan.th * plan.tw // 2 % 64 == 0 and plan.tw % 16 == 0  # m64 blocks per half
        assert 1 <= plan.depth <= k5.CONV3_MAX_STAGES
        assert plan.smem == k5.conv3_smem(ci, plan.nb, plan.th, plan.tw, plan.depth)
        for name, (dims, strides, box) in _maps(plan, H, W, ci, co).items():
            assert all(1 <= b <= 256 for b in box), (ci, co, name, box)
            assert all(b <= d for b, d in zip(box[:1], dims)), (ci, co, name, box)
            assert all(s % 16 == 0 for s in strides), (ci, co, name, strides)
            assert box[0] * 2 in (32, 64, 128), (ci, co, name, box)  # the swizzle span


def test_plans_reject_convs_without_instantiation():
    with pytest.raises(ValueError, match="instantiation"):
        k5.conv_plan(3, 48, 48)
    with pytest.raises(ValueError, match="instantiation"):
        k5.conv_plan(1, 24, 16)


# the kernel's rounding (bf16 output of the f32 sums), and the faults of the k5 phase:
# the halo rows at the tile seams zeroed, one tap left out, one tile from a stale stage
@pytest.mark.parametrize("fault", ["none", "halo", "tap", "stale"])
def test_k5_limit_admits_bf16_rounding_and_rejects_faults(fault):
    gen = torch.Generator().manual_seed(5)
    B, H, W, Ci, Co = 1, 37, 70, 16, 16

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(torch.bfloat16)

    x, w, b, r = rnd(B, H, W, Ci), rnd(3, 3, Ci, Co, std=(9 * Ci) ** -0.5), \
        rnd(Co, std=0.1), rnd(B, H, W, Co)
    plain = k5.conv3x3_bias_act_plain
    want = plain(x.float(), w.float(), b.float(), r.float(), relu=True)
    if fault == "none":
        ratio = chip_smoke.k5_err_over_limit(torch, plain(x, w, b, r, relu=True), want)
        assert ratio <= 1
    else:
        plan = k5.conv_plan(3, Ci, Co)
        assert H > plan.th and W >= 2 * plan.tw  # tile seams and a second tile exist
        faults = chip_smoke.k5_faults(torch, plain, plan, x, w, b, r, True, want)
        assert faults[fault] > 1, faults
