"""The traffic repeats from the seed and changes with it."""
import numpy as np
import torch

from benchmark import harness
from benchmark.traffic import frames, rallies

SEED = 2 ** 31 + 977  # seeds run past 32 signed bits


def test_schedule_repeats_from_the_seed():
    groups = [[100, 250], [125, 225], [175, 175]]
    a = rallies.schedule(SEED, groups, 320, 12)
    assert a == rallies.schedule(SEED, groups, 320, 12)
    assert a != rallies.schedule(SEED + 1, groups, 320, 12)
    # every group holds the same frames and every cycle the same groups, so every seed
    # does the same work at every group's end
    assert all(sum(T for _, T in g) == 350 for g in a)
    for c in range(4):
        assert sorted(sorted(T for _, T in g) for g in a[3 * c:3 * c + 3]) == sorted(groups)
    assert all(0 <= o <= 320 - T for g in a for o, T in g)


def test_frames_repeat_from_the_seed():
    p = harness.load_cell("ensemble_i420_full").traffic["frames"]
    for fmt in ("rgb", "i420"):
        a = frames.frame_pool(SEED, 5, (64, 36), p, fmt, "cpu")
        b = frames.frame_pool(SEED, 5, (64, 36), p, fmt, "cpu")
        c = frames.frame_pool(SEED + 1, 5, (64, 36), p, fmt, "cpu")
        assert a.dtype == np.uint8 and np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (5, 54, 64)


def test_i420_matches_the_pools_rgb_through_the_reference_conversion():
    from benchmark.reference import ingest

    p = harness.load_cell("ensemble_i420_full").traffic["frames"]
    rgb = frames.frame_pool(SEED, 3, (64, 36), p, "rgb", "cpu")
    yuv = frames.frame_pool(SEED, 3, (64, 36), p, "i420", "cpu")
    back = ingest.i420_to_rgb(torch.from_numpy(yuv), 36, 64).int()
    # 4:2:0 averages chroma over 2x2 pixels: the round trip is close, not exact
    assert (back - torch.from_numpy(rgb).int()).abs().float().mean() < 12


def test_weights_repeat_from_the_seed():
    from benchmark import weights
    from benchmark.reference.uplifting import Uplifting

    cfg = harness.load_cell("ensemble_i420_full").config["uplifting"]
    t = weights.meta_module(lambda: Uplifting(cfg))
    a = weights.make_state(t, torch.Generator().manual_seed(SEED), torch.float32, "cpu")
    b = weights.make_state(t, torch.Generator().manual_seed(SEED), torch.float32, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["firststage.layers_0.norm1.weight"].min()) == 1.0
    assert float(a["firststage.layers_0.attn.qkv.bias"].abs().max()) == 0.0
