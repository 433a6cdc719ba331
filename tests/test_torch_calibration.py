"""Camera calibration of the port against the JAX package.

The deterministic pieces (DLT, RQ, decomposition, the residual Jacobian, LM from one
start) are held in f32. The whole RANSAC calibration is held with JAX's own draws
(PRNGKey(42)) passed to the port, in float64 on both sides: LM from the DLT start of the
near-planar table is chaotic in f32 (on the cases below two f32 implementations part
after two steps, from a focal length of about 40 px), so only f64 shows whether the two
compute the same function. The port's f32 path with its own seeded draws is judged by
outcome, as tests/test_calibration.py judges the JAX one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core import calibration as JC
from upliftingtabletennis_tpu.core.geometry import get_Mext as jax_get_Mext
from upliftingtabletennis_tpu.core.geometry import world2img as jax_world2img
from upliftingtabletennis_torch.core import calibration as C
from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, get_Mext, world2img
from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

torch.set_num_threads(1)

RES = (2560, 1440)  # tests/test_calibration.py's frame
P3 = torch.from_numpy(TABLE_POINTS)


def _gt_camera(rng, fx=2710.0, fy=2907.0, res=RES):
    """A broadcast-like camera, drawn as tests/test_calibration.py draws it."""
    c = np.array([rng.uniform(-3, 3), rng.uniform(6, 12), rng.uniform(3, 7)])
    look = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), 0.76])
    f = look - c
    f = f / np.linalg.norm(f)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    Mext = get_Mext(*(torch.from_numpy(v) for v in (c, f, r))).numpy()
    Mint = np.array([[fx, 0, res[0] // 2], [0, fy, res[1] // 2], [0, 0, 1.0]])
    return Mint, Mext


def _project(Mint, Mext, noise, rng):
    pts = world2img(torch.from_numpy(TABLE_POINTS).double(), torch.from_numpy(Mext),
                    torch.from_numpy(Mint)).numpy()
    return pts + rng.normal(0, noise, pts.shape)


def test_get_Mext_and_projection_match_jax():
    rng = np.random.default_rng(0)
    c, f, r = rng.normal(size=(3, 4, 3)).astype(np.float32)
    got = get_Mext(*(torch.from_numpy(v) for v in (c, f, r))).numpy()
    want = np.asarray(jax_get_Mext(*map(jnp.asarray, (c, f, r))))
    np.testing.assert_allclose(got, want, atol=1e-6)
    Mint, Mext = _gt_camera(rng)
    got = _project(Mint, Mext, 0.0, rng)
    want = np.asarray(jax_world2img(*map(jnp.asarray, (TABLE_POINTS, Mext, Mint))))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(
        TableTennisPipeline.reproject(TABLE_POINTS, Mint, Mext, device="cpu"),
        np.asarray(jax_world2img(*(jnp.asarray(a, jnp.float32) for a in (TABLE_POINTS, Mext,
                                                                         Mint)))), atol=1e-3)


def test_euler_roundtrip_matches_jax():
    angles = np.random.default_rng(1).uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
    R = C.euler_xyz_to_matrix(torch.from_numpy(angles))
    np.testing.assert_allclose(R.numpy(), np.asarray(JC.euler_xyz_to_matrix(jnp.asarray(angles))),
                               atol=1e-6)
    np.testing.assert_allclose(C.matrix_to_euler_xyz(R).numpy(), angles, atol=1e-5)


def test_rq3_and_decomposition_match_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    K, Q = C.rq3(torch.from_numpy(M))
    for i in range(5):
        Kj, Qj = map(np.asarray, JC.rq3(jnp.asarray(M[i])))
        np.testing.assert_allclose(K[i].numpy(), Kj, atol=1e-5)
        np.testing.assert_allclose(Q[i].numpy(), Qj, atol=1e-5)
    np.testing.assert_allclose((K @ Q).numpy(), M, atol=1e-5)
    assert torch.all(torch.tril(K, -1).abs() < 1e-6)

    Mint, Mext = _gt_camera(rng)
    P = (Mint @ Mext[:3]).astype(np.float32)
    P = P / P[2, 3]
    got = C.decompose_projection_matrix(torch.from_numpy(P))
    want = JC.decompose_projection_matrix(jnp.asarray(P))
    for g, w, tol in zip(got, want, (1e-2, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol * np.abs(w).max())


def test_dlt_matches_jax_with_masked_points():
    rng = np.random.default_rng(3)
    Mint, Mext = _gt_camera(rng)
    pts = _project(Mint, Mext, 0.5, rng).astype(np.float32)
    vis = np.ones(13, np.float32)
    vis[[0, 5]] = 0.0
    pts[[0, 5]] = 1e4  # left out by their zero weight
    got = C.dlt(P3, torch.from_numpy(pts), torch.from_numpy(vis)).numpy()
    want = np.asarray(JC.dlt(jnp.asarray(TABLE_POINTS), jnp.asarray(pts), jnp.asarray(vis)))
    # the SVD's null vector in f32, normalised by P[2, 3]: its sign is fixed
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    Kd, Ed = C.dlt_calib(P3, torch.from_numpy(pts), torch.from_numpy(vis))
    Kj, Ej = JC.dlt_calib(jnp.asarray(TABLE_POINTS), jnp.asarray(pts), jnp.asarray(vis))
    np.testing.assert_allclose(Kd.numpy(), np.asarray(Kj), atol=1e-3 * np.abs(Kj).max())
    np.testing.assert_allclose(Ed.numpy(), np.asarray(Ej), atol=1e-4)


def test_residual_jacobian_matches_jax_jacfwd():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, (13, 2)).astype(np.float32) * np.float32([1920, 1080])
    x = torch.stack([C._cams_to_params(*s) for s in C.canonical_starts()])
    x = x + torch.from_numpy(rng.normal(0, 0.05, x.shape).astype(np.float32))
    got = C._residual_jacobian(x, P3, torch.from_numpy(pts), (1920, 1080)).numpy()
    for i in range(len(x)):
        want = np.asarray(jax.jacfwd(lambda v: JC._residual_dists(
            v, jnp.asarray(TABLE_POINTS), jnp.asarray(pts), (1920, 1080)))(jnp.asarray(x[i])))
        np.testing.assert_allclose(got[i], want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("objective", ["l1", "l2"])
def test_refine_camera_from_a_canonical_start_matches_jax(objective):
    """40 LM steps in f32 from one canonical start, on noisy keypoints with an outlier."""
    rng = np.random.default_rng(5)
    Mint, Mext = _gt_camera(rng, res=(1920, 1080))
    pts = _project(Mint, Mext, 1.0, rng).astype(np.float32)
    pts[3] += (300.0, -200.0)
    w = np.ones(13, np.float32)
    Ms, Es = C.canonical_starts()[1]
    got = C.refine_camera(P3, torch.from_numpy(pts), torch.from_numpy(w), (1920, 1080),
                          (Ms, Es), objective)
    want = JC.refine_camera(jnp.asarray(TABLE_POINTS), jnp.asarray(pts), jnp.asarray(w),
                            (1920, 1080), (jnp.asarray(Ms.numpy()), jnp.asarray(Es.numpy())),
                            objective)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-2)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_calibrate_camera_with_jax_draws_matches_jax(seed):
    """RANSAC with JAX's draws on both sides, in float64: every hypothesis' camera, the
    best hypothesis and its inlier count equal; the final camera within 0.1 px focal
    (the polish keeps the best of 32 restarts, a near tie may pick another of equal
    cost) and 1e-3 in the extrinsics. 1 px noise, one gross outlier."""
    rng = np.random.default_rng(seed)
    Mint, Mext = _gt_camera(rng, fx=2000.0, fy=2100.0, res=(1920, 1080))
    pts = _project(Mint, Mext, 1.0, rng)
    pts[3] += (300.0, -200.0)
    vis = np.ones(13)
    with jax.enable_x64():
        key = jax.random.PRNGKey(42)
        u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (13,)))(
            jax.random.split(key, C.RANSAC_ITERS)))
        normal = np.stack([np.asarray(jax.vmap(lambda k: jax.random.normal(k, (8,), jnp.float64))(
            jax.random.split(jax.random.fold_in(key, 1000 + rd), C.POLISH_RESTARTS)))
            for rd in range(C.POLISH_ROUNDS)])
        p3, p2, v = (jnp.asarray(a, jnp.float64) for a in (TABLE_POINTS, pts, vis))
        start = JC.dlt_calib(p3, p2, v)
        w = jax.vmap(lambda k: JC._sample_hypothesis_weights(k, v))(
            jax.random.split(key, C.RANSAC_ITERS))
        hyp = jax.vmap(lambda wi: JC.refine_camera_multistart(p3, p2, wi, (1920, 1080), start))(w)
        Kj, Ej, nj = (np.asarray(a) for a in JC.calibrate_camera(p2, v, (1920, 1080), key, True))
    p3t, p2t, vt = (torch.as_tensor(a, dtype=torch.float64) for a in (TABLE_POINTS, pts, vis))
    wt = C._sample_hypothesis_weights(torch.from_numpy(u), vt)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(w))
    hyp_t = C.refine_camera_multistart(p3t, p2t, wt, (1920, 1080), C.dlt_calib(p3t, p2t, vt))
    np.testing.assert_allclose(hyp_t[0].numpy(), np.asarray(hyp[0]), rtol=1e-6)
    np.testing.assert_allclose(hyp_t[1].numpy(), np.asarray(hyp[1]), atol=1e-6)

    def n_inliers(Ks, Es):
        Ks, Es = torch.as_tensor(np.asarray(Ks)), torch.as_tensor(np.asarray(Es))
        proj = world2img(p3t.expand(len(Ks), -1, -1), Es, Ks).numpy()
        return list((np.linalg.norm(proj - pts, axis=-1) < C.INLIER_THRESHOLD).sum(1))

    n_j, n_t = n_inliers(*hyp[:2]), n_inliers(*hyp_t[:2])
    assert n_j == n_t and int(np.argmax(n_j)) == int(np.argmax(n_t))
    Kt, Et, nt = C.calibrate_camera(p2t, vt, (1920, 1080), True, ransac_u=torch.from_numpy(u),
                                    polish_normal=torch.from_numpy(normal))
    assert int(nt) == int(nj) == max(n_j)
    np.testing.assert_allclose(Kt.numpy(), Kj, atol=0.1)
    np.testing.assert_allclose(Et.numpy(), Ej, atol=1e-3)


@pytest.mark.parametrize("use_ransac", [False, True])
def test_calibrate_noisy_with_own_draws(use_ransac):
    """tests/test_calibration.py:76 on the port in f32 with its seeded draws."""
    rng = np.random.default_rng(3)
    Mint, Mext = _gt_camera(rng)
    pts = _project(Mint, Mext, 1.5, rng).astype(np.float32)
    K, E, n_in = C.calibrate_camera(torch.from_numpy(pts), torch.ones(13), RES, use_ransac)
    err = np.linalg.norm(world2img(P3, E, K).numpy() - pts, axis=-1).mean()
    assert err < 6.0, err
    assert int(n_in) >= 6 if use_ransac else int(n_in) == 13


def test_calibrate_with_outlier_ransac_with_own_draws():
    """tests/test_calibration.py:95 on the port: RANSAC rejects a gross outlier."""
    rng = np.random.default_rng(4)
    Mint, Mext = _gt_camera(rng)
    pts = _project(Mint, Mext, 0.5, rng).astype(np.float32)
    pts[3] += np.array([300.0, -200.0], np.float32)
    K, E, n_in = C.calibrate_from_keypoints(
        torch.from_numpy(np.concatenate([pts, np.ones((13, 1), np.float32)], -1)), RES)
    err = np.linalg.norm(world2img(P3, E, K).numpy() - pts, axis=-1)
    assert np.delete(err, 3).mean() < 3.0, err
    assert err[3] > 50 and 6 <= int(n_in) <= 12


def test_default_draws_are_seeded():
    a, b = C.draw_calibration_noise(), C.draw_calibration_noise()
    assert a[0].shape == (C.RANSAC_ITERS, 13) and a[1].shape == (C.POLISH_ROUNDS,
                                                                 C.POLISH_RESTARTS, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
