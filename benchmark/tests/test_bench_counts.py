"""The frozen counts against sums worked by hand at small shapes."""
import json

import pytest

from benchmark.counts import bounds, models, peaks, work
from tests_helpers import BENCH


def test_k1_bound_by_hand():
    # B=1, N=4, C=2, heads=1, Nkv=2: bytes 2*(2*4*2 + 2*2*2 + 2*4 + 4*2) = 2*(16+8+8+8) = 80;
    # flops 4*4*2*2 + 4*4*2*2 = 64 + 64 = 128; exps 4*2 = 8
    t, by = bounds.k1_bound(1, 4, 2, 1, 2)
    want = max(80 / peaks.HBM_BYTES_PER_S, max(128 / peaks.BF16_TC_FLOPS, 8 / peaks.SFU_PER_S))
    assert t == pytest.approx(want, rel=1e-12)
    assert by == "bytes"


def test_k5_and_k4_bounds_by_hand():
    # 3x3, B=1, 2x2 grid, Ci=Co=1, residual: bytes 2*4*(1+2) + 2*9 + 4 = 46; flops 2*4*9 = 72
    t, _ = bounds.k5_bound(3, 1, 2, 2, 1, 1, True)
    assert t == pytest.approx(max(46 / peaks.HBM_BYTES_PER_S, 72 / peaks.BF16_TC_FLOPS))
    # K4 backward, B=1, 1x1 grid, C=1: bytes 2*(3+9) + 40 = 64; flops 38
    t, _ = bounds.k4_bwd_bound(1, 1, 1, 1)
    assert t == pytest.approx(max(64 / peaks.HBM_BYTES_PER_S, 38 / peaks.FP32_FLOPS))


def test_segformer_flops_by_hand():
    # one stage, C=2, depth 1, heads 1, sr 1, mlp ratio 1, decoder 3, input 8x8 with one
    # input frame: the 7x7 stride-4 embedding gives a 2x2 grid (N=4), Nkv=4
    seg = {"dims": [2], "depths": [1], "heads": [1], "sr_ratios": [1], "mlp_ratio": 1,
           "decoder_dim": 3}
    N, C, hid = 4, 2, 2
    embed = 2 * N * 49 * 3 * C
    block = 2 * N * C * C * 2 + 2 * N * C * 2 * C + 2 * 2 * N * N * C + 2 * 2 * N * C * hid \
        + 2 * 9 * N * hid
    head = 2 * N * C * 3 + 2 * N * 3 * 1
    assert models.segformer_flops(seg, 8, 8, 1, 1) == embed + block + head


def test_hrnet_graph_matches_the_published_launch_counts():
    cfg = json.loads((BENCH / "configs" / "tt_ensemble_b2.json").read_text())
    convs = models.hrnet_convs(cfg["hrnet"], 1280, 704, 3, 3)
    s1_3x3 = [c for c in convs if c["ks"] == 3 and c["stride"] == 1]
    s1_1x1 = [c for c in convs if c["ks"] == 1 and c["stride"] == 1]
    s2 = [c for c in convs if c["stride"] == 2]
    assert (len(s1_3x3), len(s1_1x1), len(s2)) == (40, 14, 18)  # K5a, K5b, stride 2
    assert convs[0]["Ci"] == 9 and convs[-1]["Co"] == 3
    assert work.k5a_seconds(cfg, "ball_aux", 8) > work.k5a_seconds(cfg, "ball_aux", 1)


def test_mit_b2_stage_shapes_at_1600x896():
    cfg = json.loads((BENCH / "configs" / "tt_ensemble_b2.json").read_text())
    st = models.mit_stages(cfg["segformer"]["b2"], 1600, 896)
    assert [(s["H"], s["W"], s["C"], s["heads"], s["Nkv"], s["depth"]) for s in st] == [
        (224, 400, 64, 1, 1400, 3), (112, 200, 128, 2, 1400, 4), (56, 100, 320, 5, 1400, 6),
        (28, 50, 512, 8, 1400, 3)]  # chip_smoke.py's B2_STAGES


@pytest.mark.parametrize("fn, args, nbytes, ops", [
    # K2, B=1, N=2, C=1, HID=2: bytes 2*(4 + 4 + 18 + 4 + 3) = 66; fc ops 4*2*1*2 = 16 (tensor
    # cores), depthwise 2*9*2*2 = 72 (f32)
    (bounds.k2_bound, (1, 2, 1, 2), 66, None),
    # K3, B=1, Nq=2, Nkv=3, heads=1, hd=2: bytes 2*(8 + 12) = 40; ops 4*2*3*2 = 48; exps 6
    (bounds.k3_bound, (1, 2, 3, 1, 2), 40, 48 / peaks.BF16_TC_FLOPS),
    # K4, B=1, 1x2 grid, C=1: bytes 2*(4 + 10) = 28; ops 18*2 = 36 (f32)
    (bounds.k4_bound, (1, 1, 2, 1), 28, 36 / peaks.FP32_FLOPS),
    # K6, N=3: bytes 60 + 24 + 3 = 87; ops 20*3 = 60 (f32)
    (bounds.k6_bound, (3,), 87, 60 / peaks.FP32_FLOPS),
])
def test_more_bounds_by_hand(fn, args, nbytes, ops):
    t, _ = fn(*args)
    t_ops = ops if ops is not None else max(16 / peaks.BF16_TC_FLOPS, 72 / peaks.FP32_FLOPS)
    if fn is bounds.k3_bound:
        t_ops = max(t_ops, 6 / peaks.SFU_PER_S)
    assert t == pytest.approx(max(nbytes / peaks.HBM_BYTES_PER_S, t_ops), rel=1e-12)
