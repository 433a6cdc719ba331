"""The detector trainer's data pieces of the port against the JAX package: the augmentation
fed JAX's own random draws (`data/image_transforms.py`), the metrics, the loss and the
targets (`eval/metrics.py`), and the PNG reader (`data/png.py`) against cv2.

Tolerances: visibility exactly; coordinates within 1e-3 px (3x3 f32 products); images
within 1e-3 in [0, 255] for the warp and the jitter each, 2.5e-3 for the two in a row
(the jitter scales the warp's error by up to (1 + contrast)(1 + saturation) = 1.44),
compared after normalisation at that over 255 * 0.225, the smallest ImageNet std); metrics, loss and targets within 1e-6; the PNG reader bit for bit. The
images are textured like frames (neighbours differ by at most about 30): the JAX warp's
f32 inverse of the affine is off by up to 4e-6 px, which on noise images (neighbours
255 apart) alone moves a sample by 1e-3.

The whole JAX pipeline is held as JAX runs it op by op (`jax.disable_jit()`): jitted
whole, XLA's fused program takes the wrong HSV branch on pixels whose largest channel it
recomputes with other roundings (RGB (129.9, 129.6, 83.4) comes out with red and blue
swapped: 4.1 apart in normalised units, on 751 of 124,416 values of this batch). The
port computes the function as written.
"""
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.data import image_transforms as J
from upliftingtabletennis_tpu.eval import metrics as JM
from upliftingtabletennis_torch.data import image_transforms as P
from upliftingtabletennis_torch.data.png import read_png, write_png
from upliftingtabletennis_torch.eval import metrics as PM

torch.set_num_threads(1)
IMG_TOL = 1e-3
NORM_TOL = 2.5 * IMG_TOL / (255 * min(J.IMAGENET_STD.tolist()))
ALL_ON = J.ImageAugmentConfig(flip_prob=1.0, rot_prob=1.0, transl_prob=1.0, crop_prob=1.0,
                              jitter_prob=1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, n, B):
    """The [0, 1) uniforms behind each of JAX's `n` split keys, (n, B)."""
    return np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in jax.random.split(key, n)])


def _batch(seed, B=6, H=40, W=56, frames=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W][..., None]
    phase = rng.uniform(0, 6.3, (B, 1, 1, 3 * frames))
    images = (120 + 100 * np.sin(xx / 5.0 + phase) * np.cos(yy / 7.0 - phase)
              + rng.uniform(0, 10, (B, H, W, 3 * frames))).astype(np.float32)
    coords = rng.uniform([-5, -5], [W + 5, H + 5], (B, 3, 2)).astype(np.float32)
    vis = (rng.uniform(size=(B, 3)) < 0.8).astype(np.float32)
    return images, coords, vis


@pytest.mark.parametrize("cfg", [J.ImageAugmentConfig(), ALL_ON], ids=["default", "all_on"])
def test_affines_coords_visibility_and_warp_match_jax(cfg):
    images, coords, vis = _batch(0)
    B, H, W, _ = images.shape
    key, dst = jax.random.PRNGKey(3), (48, 32)
    A_j, st_j = J.sample_affines(key, B, (H, W), dst, cfg, True)
    A, st = P.sample_affines(_t(_jax_draws(key, 8, B)), (H, W), dst, cfg, True)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=1e-6, atol=1e-5)
    for k in ("RF", "TRF", "CTRF", "crop_wh"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(P.transform_coords(A, _t(coords)).numpy(),
                               np.asarray(J.transform_coords(A_j, jnp.asarray(coords))),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(P.update_visibility(st, _t(coords), _t(vis)).numpy(),
                                  np.asarray(J.update_visibility(st_j, jnp.asarray(coords),
                                                                 jnp.asarray(vis))))
    # the warp on the same affines, so its own arithmetic is held
    np.testing.assert_allclose(P.warp_images(_t(images), _t(A_j), dst).numpy(),
                               np.asarray(J.warp_images(jnp.asarray(images), A_j, dst)),
                               rtol=0, atol=IMG_TOL)


def test_color_jitter_matches_jax():
    images, _, _ = _batch(1, frames=3)
    key = jax.random.PRNGKey(5)
    for cfg in (J.ImageAugmentConfig(), ALL_ON):
        want = np.asarray(J.color_jitter(key, jnp.asarray(images), cfg))
        got = P.color_jitter(_t(_jax_draws(key, 5, images.shape[0])), _t(images), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_TOL)
    assert np.abs(got - images).max() > 1.0  # all_on jitters every sample


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_augment_detection_batch_matches_jax(train):
    images, coords, vis = _batch(2)
    key, dst = jax.random.PRNGKey(7), (64, 36)
    with jax.disable_jit():
        want = J.augment_detection_batch(key, jnp.asarray(images), jnp.asarray(coords),
                                         jnp.asarray(vis), dst, ALL_ON, train)
    k1, k2 = jax.random.split(key)
    B = images.shape[0]
    draws = (_t(_jax_draws(k1, 8, B)), _t(_jax_draws(k2, 5, B)))
    got = P.augment_detection_batch(None, _t(images), _t(coords), _t(vis), dst, ALL_ON, train,
                                    draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=NORM_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_augment_draws_keep_the_reference_correlations():
    """tx/W and ty/H come from one draw, as do ox and oy: the reference's structure."""
    gen = torch.Generator().manual_seed(0)
    u = P.draw_affine_uniforms(gen, 64)
    assert u.shape == (8, 64) and float(u.min()) >= 0 and float(u.max()) < 1
    H, W = 100, 200
    _, st = P.sample_affines(u, (H, W), (50, 25), ALL_ON, True)
    T = st["TRF"] @ torch.linalg.inv(st["RF"])
    tx, ty = T[:, 0, 2], T[:, 1, 2]
    torch.testing.assert_close(tx / (0.2 * W), ty / (0.2 * H), atol=1e-5, rtol=1e-5)


def test_metrics_loss_and_targets_match_jax():
    rng = np.random.default_rng(4)
    N = 40
    p, e1, e2 = (rng.uniform(-20, 20, (N, 2)).astype(np.float32) for _ in range(3))
    e2[:5] = e1[:5]  # degenerate segments
    np.testing.assert_allclose(PM.point_segment_distance(_t(p), _t(e1), _t(e2)).numpy(),
                               np.asarray(JM.point_segment_distance(p, e1, e2)), atol=1e-6)
    e3 = rng.uniform(-20, 20, (N, 2)).astype(np.float32)
    np.testing.assert_allclose(PM.distance_to_streak(_t(p), _t(e1), _t(e2), _t(e3)).numpy(),
                               np.asarray(JM.distance_to_streak(p, e1, e2, e3)), atol=1e-6)
    preds = np.concatenate([p, (rng.uniform(size=(N, 1)) < 0.7)], -1).astype(np.float32)
    for tol in (2, 5, 10, 20):
        assert abs(float(PM.pck_ball(_t(preds), _t(e2), _t(e1), _t(e3), tol))
                   - float(JM.pck_ball(preds, e2, e1, e3, tol))) <= 1e-6
    none = preds.copy()
    none[:, 2] = 0
    assert float(PM.pck_ball(_t(none), _t(e2), _t(e1), _t(e3), 5)) == -1.0
    kp = rng.uniform(0, 30, (6, 13, 3)).astype(np.float32)
    kg = kp + rng.normal(0, 4, kp.shape).astype(np.float32)
    kp[..., 2] = rng.uniform(size=(6, 13)) < 0.8
    kg[..., 2] = rng.uniform(size=(6, 13)) < 0.8
    for tol in (2, 5, 10):
        assert abs(float(PM.pck_keypoints(_t(kp), _t(kg), tol))
                   - float(JM.pck_keypoints(kp, kg, tol))) <= 1e-6
    kp[..., 2] = 0
    assert float(PM.pck_keypoints(_t(kp), _t(kg), 5)) == -1.0
    c = rng.uniform(-5, 70, (3, 2, 2)).astype(np.float32)
    v = np.array([[1, 0], [1, 1], [0, 1]], np.float32)
    hm = PM.render_gaussian_heatmaps(_t(c), _t(v), 40, 64, 4.0).numpy()
    np.testing.assert_allclose(hm, np.asarray(JM.render_gaussian_heatmaps(c, v, 40, 64, 4.0)),
                               atol=1e-6)
    pred = rng.normal(0, 0.3, hm.shape).astype(np.float32)
    assert abs(float(PM.weighted_mse_loss(_t(pred), _t(hm)))
               - float(JM.weighted_mse_loss(pred, hm))) <= 1e-6 * float(
                   JM.weighted_mse_loss(pred, hm))


def _png(path, img, filters, colour, depth=8, interlace=0):
    """Write a PNG with the given filter type on each row (cycled)."""
    H, W = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    x = img.reshape(H, W * bpp).astype(np.int32)
    rows = []
    prev = np.zeros(W * bpp, np.int32)
    for r in range(H):
        f = filters[r % len(filters)]
        cur = x[r]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            pa, pb, pc = np.abs(prev - upleft), np.abs(left - upleft), np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace)
    data = zlib.compress(b"".join(rows))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data[:17])
                     + chunk(b"IDAT", data[17:]) + chunk(b"IEND", b""))


def _cv2_rgb(path):
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if ref.ndim == 2:
        return ref[..., None]
    return ref[..., [2, 1, 0, 3][:ref.shape[2]]]


def test_png_reader_is_bit_equal_to_cv2(tmp_path):
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 6, (xx + yy) * 3, 255 - xx], -1) % 256
    for name, shape in (("rgb", (37, 53, 3)), ("grey", (23, 31)), ("rgba", (19, 29, 4))):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"{name}.png"), img)  # libpng picks the filters
        np.testing.assert_array_equal(read_png(tmp_path / f"{name}.png"),
                                      _cv2_rgb(tmp_path / f"{name}.png"))
    # every filter, and the four mixed on alternating rows, each read back as cv2 reads it
    for colour, bpp in ((2, 3), (0, 1), (6, 4)):
        img = (smooth[..., :bpp] + rng.integers(0, 9, (37, 53, bpp))).astype(np.uint8)
        for filters in ([0], [1], [2], [3], [4], [4, 3, 1, 2, 0, 3]):
            path = tmp_path / f"f{colour}_{''.join(map(str, filters))}.png"
            _png(path, img if bpp > 1 else img[..., 0], filters, colour)
            got = read_png(path)
            np.testing.assert_array_equal(got, img)
            np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_png_writer_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(7)
    for shape in ((9, 14, 3), (5, 6), (7, 3, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(tmp_path / "w.png", img)
        got = read_png(tmp_path / "w.png")
        np.testing.assert_array_equal(got, img.reshape(got.shape))
        np.testing.assert_array_equal(got, _cv2_rgb(tmp_path / "w.png"))


def test_png_reader_refuses_what_it_does_not_take(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    for what, kw in (("depth", dict(depth=16)), ("interlace", dict(interlace=1))):
        _png(tmp_path / f"{what}.png", img, [0], 2, **kw)
        with pytest.raises(ValueError, match="unsupported"):
            read_png(tmp_path / f"{what}.png")
    _png(tmp_path / "palette.png", img[..., 0], [0], 3)
    with pytest.raises(ValueError, match="unsupported"):
        read_png(tmp_path / "palette.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")
