"""The port's synthetic uplifting data (data/synthetic.py) against the JAX package.

JAX's own draws (the same `jax.random` keys and splits as `sample_cameras` and
`assemble_batch`) go through the port's functions of draws. The stores, the splits, the
resampling and the camera picks are exact (integer and boolean outputs equal, gathered
positions equal). Float outputs: the cameras within 2e-5 (Mext, entries up to about 17 m)
and 1e-3 (Mint, focal lengths of thousands of px), projections within 1e-2 px: the same
f32 operations, with sin, cos and the norms rounded by other libraries.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uplift_data import analytic_datagen
from upliftingtabletennis_tpu.data import synthetic as JSYN
from upliftingtabletennis_torch.data import synthetic as SYN

torch.set_num_threads(1)
MEXT_ATOL, MINT_ATOL, PX_ATOL = 2e-5, 1e-3, 1e-2
# The JAX side runs jitted whole: op by op its first calls cost seconds of compiles.


@pytest.fixture(scope="module")
def store():
    return SYN.store_from_datagen(analytic_datagen(24, seed=1))


def _assert_stores_equal(a, b):
    for f in SYN.TrajectoryStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)


def test_store_from_datagen_matches_jax():
    res = analytic_datagen(6, seed=2)
    got, want = SYN.store_from_datagen(res), JSYN.store_from_datagen(res)
    for f in ("blur_positions", "blur_mask", "rotations", "bounces"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    # the simulation camera: the port builds it in f64, JAX in f32
    np.testing.assert_allclose(got.Mext, np.asarray(want.Mext), atol=MEXT_ATOL)
    np.testing.assert_allclose(got.Mint, np.asarray(want.Mint), atol=MINT_ATOL)


def test_store_npz_loads_in_both_packages(tmp_path, store):
    SYN.save_store_npz(str(tmp_path / "a" / "left_to_right.npz"), store)
    _assert_stores_equal(JSYN.load_store_npz(str(tmp_path / "a" / "left_to_right.npz")), store)
    JSYN.save_store_npz(str(tmp_path / "b.npz"), store)
    _assert_stores_equal(SYN.load_store_npz(str(tmp_path / "b.npz")), store)


def test_reference_layout_loads_in_both_packages(tmp_path, store):
    small = store.subset(np.arange(5))
    SYN.save_reference_layout(str(tmp_path / "port"), small)
    JSYN.save_reference_layout(str(tmp_path / "jax"), small)
    for d in ("port", "jax"):
        _assert_stores_equal(SYN.store_from_disk(str(tmp_path / d), pad_to=500),
                             JSYN.store_from_disk(str(tmp_path / d), pad_to=500))
    for name in sorted(os.listdir(tmp_path / "jax" / "trajectory_0003")):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "trajectory_0003" / name),
                                      np.load(tmp_path / "jax" / "trajectory_0003" / name))


def test_concat_stores_matches_jax(store):
    short = store.subset(np.arange(5, 12))  # a shard with a shorter time axis
    parts = [store.subset(np.arange(0, 5)),
             SYN.TrajectoryStore(short.blur_positions[:, :300], short.blur_mask[:, :300],
                                 *short[2:])]
    _assert_stores_equal(SYN.concat_stores(parts), JSYN.concat_stores(parts))


@pytest.mark.parametrize("n", [0, 1, 7, 10, 33, 1000])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_split_indices_match_jax(n, mode):
    np.testing.assert_array_equal(SYN.split_indices(n, mode), JSYN.split_indices(n, mode))


def _camera_draws(key, shape):
    ks = jax.random.split(key, 11)
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in ks])


@pytest.mark.parametrize("back_frac", [0.0, 0.3])
def test_cameras_from_uniforms_match_sample_cameras(back_frac):
    key = jax.random.PRNGKey(5)
    Mint_j, Mext_j = jax.jit(JSYN.sample_cameras, static_argnums=(1, 2))(key, (64, 3), back_frac)
    Mint, Mext = SYN.cameras_from_uniforms(torch.from_numpy(_camera_draws(key, (64, 3))),
                                           back_frac)
    np.testing.assert_allclose(Mint.numpy(), np.asarray(Mint_j), atol=MINT_ATOL)
    np.testing.assert_allclose(Mext.numpy(), np.asarray(Mext_j), atol=MEXT_ATOL)


def _jax_resampled(store, idx, fps):
    st = jax.tree.map(jnp.asarray, store)
    return [np.asarray(a) for a in jax.jit(JSYN._resample)(st.blur_positions[idx],
                                                           st.blur_mask[idx], jnp.asarray(fps))]


def test_resample_matches_jax(store):
    idx = np.arange(len(store))
    fps = np.random.default_rng(0).integers(20, 66, len(idx))
    fps[:4] = (20, 40, 50, 65)  # 40 fps puts times x 500 on half-integers: round half to even
    want = _jax_resampled(store, idx, fps)
    dev = SYN.store_to_device(store, "cpu")
    got = SYN._resample(dev.blur_positions[idx], dev.blur_mask[idx], torch.from_numpy(fps))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("back_frac", [0.0, 0.3])
def test_pick_valid_camera_picks_as_jax(store, back_frac):
    idx = np.arange(16)
    r_world, mask, _ = _jax_resampled(store, idx, np.full(16, 30))
    key = jax.random.PRNGKey(11)
    Mint_j, Mext_j, has_j = jax.jit(JSYN.pick_valid_camera, static_argnums=(3, 4))(
        key, jnp.asarray(r_world), jnp.asarray(mask), JSYN.NUM_CAMERA_TRIES, back_frac)
    u = torch.from_numpy(_camera_draws(key, (16, JSYN.NUM_CAMERA_TRIES)))
    Mint, Mext, found, pick = SYN.pick_valid_camera(torch.tensor(r_world), torch.tensor(mask),
                                                    u, back_frac)
    np.testing.assert_array_equal(found.numpy(), np.asarray(has_j))
    assert found.any() and (pick > 0).any()  # the rejection is exercised
    # the same candidate: the picked cameras agree to rounding
    np.testing.assert_allclose(Mext.numpy(), np.asarray(Mext_j), atol=MEXT_ATOL)
    np.testing.assert_allclose(Mint.numpy(), np.asarray(Mint_j), atol=MINT_ATOL)
    Mint_all, _ = SYN.cameras_from_uniforms(u, back_frac)
    np.testing.assert_array_equal(Mint.numpy(), Mint_all[torch.arange(16), pick].numpy())


def _jax_batch_draws(key, B):
    """The draws of the JAX assemble_batch(key, ..., train=True) for B trajectories."""
    k_fps, k_cam = jax.random.split(key)
    fps = np.asarray(jax.random.randint(k_fps, (B,), JSYN.FPS_BOUNDS[0], JSYN.FPS_BOUNDS[1] + 1))
    return SYN.BatchDraws(torch.from_numpy(fps).long(),
                          torch.from_numpy(_camera_draws(k_cam, (B, JSYN.NUM_CAMERA_TRIES))))


EXACT = ("r_world", "mask", "hits", "rotation", "blur_positions", "blur_mask")
# Validation batches run at the constant 50 fps: jitted whole, XLA rewrites the JAX
# function's k / 50 as k x (1 / 50), 1 ulp off the division the port computes.
TIMES_ATOL = 1.2e-7


@pytest.mark.parametrize("train,back_frac", [(True, 0.0), (True, 0.3), (False, 0.0)])
def test_assemble_batch_matches_jax(store, train, back_frac):
    idx = np.array([3, 0, 7, 7, 12, 21, 5, 9])
    key = jax.random.PRNGKey(7)
    want = JSYN.assemble_batch(key, jax.tree.map(jnp.asarray, store), jnp.asarray(idx),
                               train=train, back_frac=back_frac)
    draws = _jax_batch_draws(key, len(idx)) if train else SYN.BatchDraws(None, None)
    got = SYN.assemble_batch_from_draws(SYN.store_to_device(store, "cpu"), torch.from_numpy(idx),
                                        draws, train=train, back_frac=back_frac)
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    np.testing.assert_allclose(got["times"].numpy(), np.asarray(want["times"]),
                               atol=0 if train else TIMES_ATOL, rtol=0)
    np.testing.assert_allclose(got["Mext"].numpy(), np.asarray(want["Mext"]), atol=MEXT_ATOL)
    np.testing.assert_allclose(got["Mint"].numpy(), np.asarray(want["Mint"]), atol=MINT_ATOL)
    for k in ("r_img", "table_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PX_ATOL, rtol=0)
    assert got["r_img"].shape == (len(idx), SYN.SEQUENCE_LEN, 2)
    assert (got["table_img"][..., 2] == 1).all()
    if train:
        assert got["camera_found"].all()


def test_draw_batch_ranges():
    gen = torch.Generator().manual_seed(0)
    d = SYN.draw_batch(4096, True, gen, "cpu")
    assert d.fps.min() == 20 and d.fps.max() == 65
    assert d.camera_u.shape == (SYN.N_CAMERA_STREAMS, 4096, SYN.NUM_CAMERA_TRIES)
    assert SYN.draw_batch(8, False, gen, "cpu") == SYN.BatchDraws(None, None)
    if not torch.cuda.is_available():  # the default device is the card; no CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            SYN.draw_batch(8, True, None)


def test_generate_production_shards_load_in_both_packages(tmp_path, monkeypatch, capsys):
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import generate_production

    calls = []

    def generate(n, mode, direction, batch, max_seconds, generator, device):
        calls.append((n, mode, direction, batch, max_seconds))
        return {**analytic_datagen(n, seed=len(calls)), "candidates": batch,
                "accepted_total": n}

    monkeypatch.setattr(DG, "generate_dataset", generate)
    out = str(tmp_path / "corpus")
    argv = ["--out", out, "--scale", "0.001", "--modes", "intermediate,final_win", "--batch",
            "512", "--max_seconds_per_shard", "2.5", "--device", "cpu"]
    shards = generate_production.main(argv)
    # the recipe scaled (50k and 5k per direction), the time cap on final_win only
    assert calls == [(50, "intermediate", "left_to_right", 512, 0.0),
                     (50, "intermediate", "right_to_left", 512, 0.0),
                     (5, "final_win", "left_to_right", 512, 2.5),
                     (5, "final_win", "right_to_left", 512, 2.5)]
    assert [s["accepted"] for s in shards] == [50, 50, 5, 5]
    for mode, direction in (("intermediate", "right_to_left"), ("final_win", "left_to_right")):
        path = os.path.join(out, mode, f"{direction}.npz")
        _assert_stores_equal(SYN.load_store_npz(path), JSYN.load_store_npz(path))
    assert generate_production.main(argv) == []  # existing shards are skipped
    assert "[skip]" in capsys.readouterr().out
    # --dp on one device is the run without it, as in JAX (two devices:
    # tests/test_torch_parallel.py): the existing shards are skipped again
    assert generate_production.main(argv + ["--dp"]) == []
