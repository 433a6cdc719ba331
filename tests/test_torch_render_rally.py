"""The port's closed-loop renderer (`data/render_rally.py`) against the JAX package's.

* `render_frames` on cameras from the JAX sampler, with the floor and marker context,
  at 192x112 and at 1920x1080 (B = 2, one ball visible, one not), with JAX's sensor noise
  (`jax.random.normal(key, (B, H, W))`) fed in: the uint8 frames are equal but for
  knife-edge pixels, at most 1e-4 of the pixels (7-8 of 2,073,600 per frame pair at
  1080p; none at 192x112).
* `rescale_px` within 1e-5 px (it is bit-equal); `project_context` within 1e-5 px or
  2 f32 ulps of the camera's farthest context coordinate (the context lies up to about
  5,000 px out, where one ulp is 4.9e-4 px: JAX's f32 projection is itself 4.5e-4 px
  from float64 there).
* The port of tests/test_closed_loop.py's context test: the context breaks the mirror
  symmetry of the bare table, and the markers are coloured.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core.geometry import TABLE_POINTS, world2img
from upliftingtabletennis_tpu.data import render_rally as JR
from upliftingtabletennis_tpu.data.synthetic import sample_cameras
from upliftingtabletennis_torch.data import render_rally as PR

torch.set_num_threads(2)

KNIFE_EDGE_SHARE = 1e-4
PX_TOL = 1e-5
UPL = (2560, 1440)


@pytest.fixture(scope="module")
def cameras():
    Mint, Mext = sample_cameras(jax.random.PRNGKey(3), (4,))
    table = world2img(jnp.asarray(TABLE_POINTS), Mext[:, None], Mint[:, None])
    return np.asarray(Mint), np.asarray(Mext), np.asarray(table)


def test_project_context_and_rescale_match_jax(cameras):
    Mint, Mext, table = (a.copy() for a in cameras)
    want = np.asarray(JR.project_context(jnp.asarray(Mint), jnp.asarray(Mext)))
    got = PR.project_context(torch.from_numpy(Mint), torch.from_numpy(Mext)).numpy()
    assert got.shape == want.shape == (4, 3, 4, 2) and np.isfinite(got).all()
    # f32's resolution at the camera's farthest context point: 2 ulps of its coordinate
    scale = np.abs(want).reshape(4, -1).max(1)[:, None, None, None]
    err = np.abs(got - want)
    print("project_context: max err", err.max(), "ulps of the scale", (err / np.spacing(scale)).max())
    assert (err <= np.maximum(PX_TOL, 2 * np.spacing(scale))).all()
    # a single camera too
    one = PR.project_context(torch.from_numpy(Mint[0]), torch.from_numpy(Mext[0])).numpy()
    np.testing.assert_array_equal(one, got[0])
    for dst in ((1920, 1080), (960, 544), (192, 112)):
        want_r = np.asarray(JR.rescale_px(table, UPL, dst))
        got_r = PR.rescale_px(table, UPL, dst).numpy()
        assert np.abs(got_r - want_r).max() <= PX_TOL


@pytest.mark.parametrize("wh", [(192, 112), (1920, 1080)], ids=["192x112", "1080p"])
@pytest.mark.parametrize("cam", [0, 1])
def test_render_frames_matches_jax_but_for_knife_edges(cameras, wh, cam):
    W, H = wh
    Mint, Mext, table = cameras
    table_px = JR.rescale_px(table[cam], UPL, wh)
    ctx_px = JR.rescale_px(JR.project_context(jnp.asarray(Mint[cam]), jnp.asarray(Mext[cam])),
                           UPL, wh)
    rng = np.random.default_rng(cam)
    ball = rng.uniform([0, 0], [W, H], (2, 2)).astype(np.float32)
    vis = np.array([1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(cam)
    want = np.asarray(JR.render_frames(key, jnp.asarray(ball), jnp.asarray(vis), table_px,
                                       height=H, width=W, context_px=ctx_px))
    noise = np.asarray(jax.random.normal(key, (2, H, W)))
    got = PR.render_frames(torch.from_numpy(ball), torch.from_numpy(vis),
                           torch.from_numpy(np.asarray(table_px)), H, W,
                           torch.from_numpy(np.asarray(ctx_px)),
                           noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, H, W, 3) and got.dtype == np.uint8
    differ = np.any(got != want, axis=-1)
    print(f"{W}x{H} camera {cam}: {int(differ.sum())} of {differ.size} pixels differ")
    assert differ.mean() <= KNIFE_EDGE_SHARE
    assert np.abs(got.astype(int) - want).max() <= 1
    # the scene is drawn: table, lines, markers and the visible ball's blob
    assert len(np.unique(got[0, ..., 0])) > 50
    bx, by = np.clip(ball[0].round().astype(int), 0, [W - 1, H - 1])
    assert int(got[0, by, bx].max()) >= int(got[1, by, bx].max())


def test_render_frames_draws_from_a_generator(cameras):
    Mint, Mext, table = cameras
    args = (torch.tensor([[60.0, 40.0]]), torch.tensor([1.0]),
            PR.rescale_px(table[0], UPL, (128, 72)))
    a = PR.render_frames(*args, 72, 128, generator=torch.Generator().manual_seed(0))
    b = PR.render_frames(*args, 72, 128, generator=torch.Generator().manual_seed(0))
    c = PR.render_frames(*args, 72, 128, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_render_context_breaks_mirror_symmetry():
    """The port of tests/test_closed_loop.py:93: a camera's view of the world mirrored
    across the net plane renders a different frame, and the umpire quad is reddish and
    the banner bluish."""
    from upliftingtabletennis_torch.core.geometry import world2img as p_world2img

    Mint, Mext = (torch.from_numpy(np.asarray(a)) for a in sample_cameras(
        jax.random.PRNGKey(3), ()))
    table = torch.from_numpy(TABLE_POINTS)
    table_px = p_world2img(table, Mext, Mint)
    ctx = PR.project_context(Mint, Mext)
    assert ctx.shape == (3, 4, 2) and torch.isfinite(ctx).all()
    W, H = 256, 144
    scale = torch.tensor([W / 2560.0, H / 1440.0])
    ball, vis = torch.tensor([[-100.0, -100.0]]), torch.tensor([0.0])
    noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, H, W))))
    f = PR.render_frames(ball, vis, table_px * scale, H, W, ctx * scale, noise=noise)
    mirror = torch.tensor([-1.0, 1.0, 1.0])
    tp_m = p_world2img(table * mirror, Mext, Mint)
    ctx_m = p_world2img(torch.from_numpy(PR.CONTEXT_QUADS_WORLD.reshape(12, 3)) * mirror,
                        Mext, Mint).reshape(3, 4, 2)
    f_m = PR.render_frames(ball, vis, tp_m * scale, H, W, ctx_m * scale, noise=noise)
    diff = (f != f_m).any(-1).float().mean()
    assert diff > 0.005, diff
    fi = f.int()
    assert (fi[..., 0] - fi[..., 2]).max() > 20
    assert (fi[..., 2] - fi[..., 0]).max() > 20
