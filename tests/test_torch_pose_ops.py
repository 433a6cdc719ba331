"""The port's pose ops (CPU) against the JAX package: `keypoints_from_heatmaps` and
the associative-embedding grouping (`nms_heatmaps`, `top_k_candidates`,
`HeatmapParser`).

Seeded numpy heatmaps go through both. Tolerances are stated per test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops import ae_grouping as jax_ae
from upliftingtabletennis_tpu.ops.heatmap_decode import keypoints_from_heatmaps as jax_decode
from upliftingtabletennis_torch.ops import ae_grouping as port_ae
from upliftingtabletennis_torch.ops.heatmap_decode import keypoints_from_heatmaps

torch.set_num_threads(1)


def _blob_heatmaps(seed, B=2, K=6, H=24, W=32):
    """Gaussian blobs with noise, plus the cases where the decoders branch: a plateau
    (the first argmax decides), a map with no positive value, maxima on each border
    and one pixel from it (no DARK offset there), and a single-pixel spike."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    hm = np.zeros((B, K, H, W), np.float32)
    for b in range(B):
        for k in range(K):
            cy, cx = rng.uniform(2, H - 3), rng.uniform(2, W - 3)
            sigma = rng.uniform(1.0, 3.0)
            hm[b, k] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma ** 2))
    hm += rng.normal(0, 0.01, hm.shape).astype(np.float32)
    hm[0, 0] = 0.25                  # plateau: every pixel the maximum
    hm[0, 1] = -np.abs(hm[0, 1])     # no positive value: coordinates -1
    hm[0, 2, 0, 7] = 3.0             # top border
    hm[0, 3, 11, W - 1] = 3.0        # right border
    hm[0, 4, H - 2, 1] = 3.0         # one pixel from two borders
    hm[1, 0, 9, 13] = 5.0            # a spike on a blob map
    return hm


@pytest.mark.parametrize("post_process", ["default", "unbiased"])
@pytest.mark.parametrize("seed", [0, 1])
def test_keypoints_from_heatmaps_matches_jax(post_process, seed):
    """Coordinates within 1e-5 px (the DARK Taylor step divides by a Hessian of the
    log map, so the blur's f32 summation order shows; the argmax and the quarter
    shift are exact); maxima equal."""
    hm = _blob_heatmaps(seed)
    want_c, want_m = map(np.asarray, jax_decode(jnp.asarray(hm), post_process=post_process))
    got_c, got_m = keypoints_from_heatmaps(torch.from_numpy(hm), post_process=post_process)
    assert got_c.shape == (2, 6, 2) and got_m.shape == (2, 6, 1)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-5, rtol=0)
    assert (got_c[0, 1] == -1).all()  # no positive value
    if post_process == "default":
        np.testing.assert_array_equal(got_c.numpy(), want_c)


def test_keypoints_from_heatmaps_kernel_size():
    hm = _blob_heatmaps(2)
    for kernel in (3, 5, 17):
        want = np.asarray(jax_decode(jnp.asarray(hm), post_process="unbiased", kernel=kernel)[0])
        got = keypoints_from_heatmaps(torch.from_numpy(hm), "unbiased", kernel)[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="post_process"):
        keypoints_from_heatmaps(torch.from_numpy(hm), "megvii")


def _zero_heavy(seed, N=2, K=4, H=20, W=28, L=2):
    """Sparse peaks on zeros, some of equal height: after the NMS most entries are 0,
    so the top-k of 30 reaches the ties."""
    rng = np.random.default_rng(seed)
    hm = np.zeros((N, K, H, W), np.float32)
    for n in range(N):
        for k in range(K):
            for _ in range(rng.integers(3, 9)):
                hm[n, k, rng.integers(H), rng.integers(W)] = rng.choice([0.5, 0.8, rng.uniform()])
    tags = rng.normal(size=(N, K, H, W, L)).astype(np.float32)
    return hm, tags


@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_nms_heatmaps_matches_jax(kernel):
    hm = np.concatenate([_blob_heatmaps(3), _blob_heatmaps(4)], 1)
    sparse, _ = _zero_heavy(5)
    for x in (hm, sparse):
        want = np.asarray(jax_ae.nms_heatmaps(jnp.asarray(x), kernel=kernel))
        np.testing.assert_array_equal(port_ae.nms_heatmaps(torch.from_numpy(x), kernel).numpy(),
                                      want)


@pytest.mark.parametrize("tag_per_joint", [True, False])
@pytest.mark.parametrize("max_people", [5, 30])
def test_top_k_candidates_matches_jax_on_ties(tag_per_joint, max_people):
    """Values, locations and tags exactly equal, ties going to the lowest index."""
    hm, tags = _zero_heavy(6)
    if not tag_per_joint:
        tags = tags[:, :1]
    want = [np.asarray(a) for a in jax_ae.top_k_candidates(
        jnp.asarray(hm), jnp.asarray(tags), max_people=max_people, tag_per_joint=tag_per_joint)]
    got = [a.numpy() for a in port_ae.top_k_candidates(
        torch.from_numpy(hm), torch.from_numpy(tags), max_people=max_people,
        tag_per_joint=tag_per_joint)]
    if max_people == 30:
        assert (want[0] == 0).sum() > 100  # the ties are reached
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _scene(seed, K=4, H=40, W=56, people=3):
    """people poses of K joints as Gaussian blobs, each with its own tag value, plus
    a second tag dimension of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    heat = np.zeros((1, K, H, W), np.float32)
    tags = np.zeros((1, K, H, W, 2), np.float32)
    for p in range(people):
        x0, y0 = rng.uniform(6, W - 12), rng.uniform(6, H - 12)
        for k in range(K):
            cx, cy = x0 + rng.uniform(-4, 4), y0 + rng.uniform(-4, 4)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 1.6 ** 2))
            heat[0, k] = np.maximum(heat[0, k], blob * rng.uniform(0.6, 1.0))
            near = blob > 0.05
            tags[0, k, near, 0] = 3.0 * p + rng.normal(0, 0.1)
    tags[..., 1] = rng.normal(0, 0.05, tags.shape[:-1])
    heat[0, 2] *= (xx < W / 2)  # drop joint 2 of the people on the right: refine fills it
    return heat, tags


@pytest.mark.parametrize("use_udp", [False, True])
@pytest.mark.parametrize("seed", [7, 8])
def test_heatmap_parser_matches_jax(use_udp, seed):
    """`parse` with adjust and refine: the same people with the same joints (scores
    and tags equal), coordinates within 1e-5 (the UDP step solves a 2x2 system)."""
    heat, tags = _scene(seed)
    cfg = {"num_joints": 4, "max_num_people": 30, "detection_threshold": 0.2,
           "tag_threshold": 1.0, "use_detection_val": True, "ignore_too_much": False,
           "tag_per_joint": True, "nms_kernel": 5, "use_udp": use_udp}
    want, want_scores = jax_ae.HeatmapParser(cfg).parse(heat, tags, adjust=True, refine=True)
    got, got_scores = port_ae.HeatmapParser(cfg, device="cpu").parse(heat, tags, adjust=True,
                                                                     refine=True)
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape
    assert want[0].shape[0] >= 2
    np.testing.assert_array_equal(got[0][..., 2:], want[0][..., 2:])
    np.testing.assert_allclose(got[0][..., :2], want[0][..., :2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-6, rtol=0)


def test_heatmap_parser_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        port_ae.HeatmapParser({"num_joints": 4})
