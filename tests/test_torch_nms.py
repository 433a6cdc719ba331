"""The port's box NMS (K6's plain versions, CPU) and OKS NMS against the JAX package.

Seeded numpy boxes (the generator of tests/test_nms.py) go through both. Every
comparison is exact: the suppression decision is a comparison of f32 values that
both sides compute with the same IEEE operations, so masks, words and keep lists
must be equal, ties included. The planted set holds the cases where order and
rounding decide: identical boxes, pairs whose IoU is exactly 0.3, 0.5 or 0.7 in
f32, tied scores and boxes that overlap nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from native.build import cpu_nms
from upliftingtabletennis_tpu.ops import nms as jax_nms
from upliftingtabletennis_torch.ops import nms as port_nms

torch.set_num_threads(1)
SIZES = (0, 1, 13, 64, 65, 130, 400)
THRESHOLDS = (0.3, 0.5, 0.7)


def _random_dets(rng, n, tie_scores=False):
    x1 = rng.uniform(0, 800, n)
    y1 = rng.uniform(0, 500, n)
    w = rng.uniform(10, 200, n)
    h = rng.uniform(10, 200, n)
    s = rng.uniform(0, 1, n)
    if tie_scores:  # a handful of distinct scores: most boxes tie with others
        s = np.round(s * 4) / 4
    return np.stack([x1, y1, x1 + w, y1 + h, s], -1).astype(np.float32)


def planted_dets():
    """Boxes whose decisions ties and exact roundings make (x1, y1, x2, y2, score)."""
    return np.array([
        [0, 0, 9, 9, 0.9], [0, 0, 9, 4, 0.8],            # IoU 50 / 100 = 0.5 exactly
        [100, 0, 109, 9, 0.9], [100, 0, 109, 2, 0.7],    # 30 / 100 = 0.3 exactly
        [200, 0, 209, 9, 0.6], [200, 0, 209, 6, 0.6],    # 70 / 100 = 0.7 exactly, tied
        [300, 300, 350, 350, 0.5], [300, 300, 350, 350, 0.5],  # identical, tied
        [300, 300, 350, 350, 0.4],                       # identical, lower score
        [500, 500, 510, 510, 0.5], [600, 600, 610, 610, 0.5],  # no overlap, tied
        [700, 0, 720, 20, 0.5],                          # tied with the identical pair
    ], np.float32)


def _cases():
    rng = np.random.default_rng(0)
    return {n: _random_dets(rng, n) for n in SIZES}


CASES = _cases()


def _pallas_over(dets, thresh):
    """The TPU kernel `_iou_tile_kernel` in interpret mode over the JAX function's
    padded boxes in score order (as tests/test_nms.py runs it), restricted to the
    strict upper triangle: (N, N) bool."""
    n = dets.shape[0]
    order = np.argsort(-dets[:, 4], kind="stable")
    n8 = -(-n // jax_nms.TILE) * jax_nms.TILE
    padded = np.zeros((n8, 8), np.float32)
    padded[:, :4] = -1e9
    padded[:n, :5] = dets[order]
    grid = n8 // jax_nms.TILE
    out = pl.pallas_call(
        jax_nms._iou_tile_kernel,
        out_shape=jax.ShapeDtypeStruct((n8, n8), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(grid, grid),
            in_specs=[pl.BlockSpec((jax_nms.TILE, 8), lambda i, j: (i, 0)),
                      pl.BlockSpec((jax_nms.TILE, 8), lambda i, j: (j, 0)),
                      pl.BlockSpec(memory_space=None)],
            out_specs=pl.BlockSpec((jax_nms.TILE, jax_nms.TILE), lambda i, j: (i, j)),
        ),
        interpret=True,
    )(jnp.asarray(padded), jnp.asarray(padded), jnp.asarray([thresh], jnp.float32))
    return np.triu(np.asarray(out)[:n, :n] > 0.5, 1)


def _port_words(dets, thresh):
    d = torch.from_numpy(dets)
    order = port_nms.score_order(d)
    return port_nms.overlap_words(d[order, :4], thresh), order


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_nms_mask_matches_jax(n, thresh):
    """The port's `nms_mask` (plain words and resolve) against `nms_mask(use_pallas=False)`."""
    dets = CASES[n]
    got = port_nms.nms_mask(torch.from_numpy(dets), thresh)
    assert got.dtype == torch.bool and got.shape == (n,)
    if n:
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(dets), thresh, use_pallas=False))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [n for n in SIZES if n])
def test_plain_words_match_pallas_kernel_interpret(n):
    """Unpacked words against the Pallas kernel in interpret mode, at each threshold."""
    dets = CASES[n]
    for thresh in THRESHOLDS:
        words, _ = _port_words(dets, thresh)
        assert words.shape == (n, -(-n // 64)) and words.dtype == torch.int64
        got = port_nms.unpack_words(words, n).numpy()
        np.testing.assert_array_equal(got, _pallas_over(dets, thresh), err_msg=str(thresh))


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_nms_matches_cpu_nms(n, thresh):
    """Keep indices in descending score order, distinct scores: the C++ cpu_nms."""
    dets = CASES[n]
    assert port_nms.nms(dets, thresh, device="cpu") == cpu_nms(dets, thresh)


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_plain_nms_matches_jax_on_tied_scores(thresh):
    """Tied scores: the stable sort visits ties in input order, as the JAX function."""
    dets = _random_dets(np.random.default_rng(1), 300, tie_scores=True)
    assert len(np.unique(dets[:, 4])) <= 5
    want = jax_nms.nms(dets, thresh, use_pallas=False)
    assert port_nms.nms(dets, thresh, device="cpu") == want
    np.testing.assert_array_equal(
        port_nms.nms_mask(torch.from_numpy(dets), thresh).numpy(),
        np.asarray(jax_nms.nms_mask(jnp.asarray(dets), thresh, use_pallas=False)))


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_planted_ties_match_jax_and_pallas(thresh):
    """The planted set: masks equal to JAX, words to the Pallas kernel; the pair at
    exactly the threshold suppresses (>=), which `>` would not."""
    dets = planted_dets()
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(dets), thresh, use_pallas=False))
    np.testing.assert_array_equal(port_nms.nms_mask(torch.from_numpy(dets), thresh).numpy(), want)
    assert port_nms.nms(dets, thresh, device="cpu") == jax_nms.nms(dets, thresh, use_pallas=False)
    words, order = _port_words(dets, thresh)
    over = port_nms.unpack_words(words, len(dets)).numpy()
    np.testing.assert_array_equal(over, _pallas_over(dets, thresh))
    exact_pair = {0.5: (0, 1), 0.3: (2, 3), 0.7: (4, 5)}[thresh]
    iou = port_nms.pair_iou_plain(torch.from_numpy(dets[:, :4]))[exact_pair].item()
    assert iou == np.float32(thresh)
    assert not want[exact_pair[1]]  # suppressed at IoU == thresh


def test_pack_words_round_trip_and_bit_63():
    rng = np.random.default_rng(2)
    over = torch.from_numpy(rng.uniform(size=(5, 130)) < 0.5)
    over[:, 63] = True  # the sign bit of the first word
    words = port_nms.pack_words(over)
    assert words.shape == (5, 3) and (words[:, 0] < 0).all()
    assert torch.equal(port_nms.unpack_words(words, 130), over)


def test_nms_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        port_nms.nms(CASES[13], 0.5)
    assert port_nms.nms(CASES[0], 0.5) == []  # nothing to run: no device needed


def _pose_db(rng, n, k=17):
    db = []
    base = rng.uniform(20, 200, (k, 3))
    for i in range(n):
        kp = base + rng.normal(0, 2.0 + 20 * (i % 3), (k, 3))
        kp[:, 2] = rng.uniform(0, 1, k)
        db.append({"keypoints": kp, "score": float(rng.uniform(0, 1)),
                   "area": float(rng.uniform(500, 5000))})
    return db


@pytest.mark.parametrize("vis_thr", [None, 0.3])
def test_oks_ops_match_jax(vis_thr):
    """oks_iou, oks_nms and soft_oks_nms: the port's numpy copies, exactly equal."""
    rng = np.random.default_rng(3)
    db = _pose_db(rng, 12)
    g, d = db[0]["keypoints"].ravel(), np.stack([p["keypoints"].ravel() for p in db[1:]])
    a_d = np.array([p["area"] for p in db[1:]])
    np.testing.assert_array_equal(port_nms.oks_iou(g, d, 900.0, a_d, vis_thr=vis_thr),
                                  jax_nms.oks_iou(g, d, 900.0, a_d, vis_thr=vis_thr))
    np.testing.assert_array_equal(port_nms.COCO_SIGMAS, jax_nms.COCO_SIGMAS)
    for thr in (0.3, 0.5, 0.9):
        assert port_nms.oks_nms(db, thr, vis_thr=vis_thr) == jax_nms.oks_nms(db, thr,
                                                                             vis_thr=vis_thr)
        assert port_nms.soft_oks_nms(db, thr, vis_thr=vis_thr, max_dets=8) == \
            jax_nms.soft_oks_nms(db, thr, vis_thr=vis_thr, max_dets=8)
    overlap, scores = rng.uniform(size=10), rng.uniform(size=10)
    for kind in ("linear", "gaussian"):
        np.testing.assert_array_equal(port_nms.rescore(overlap, scores, 0.4, kind),
                                      jax_nms.rescore(overlap, scores, 0.4, kind))
    assert port_nms.oks_nms([], 0.5) == [] and port_nms.soft_oks_nms([], 0.5) == []
