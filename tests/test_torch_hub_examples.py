"""The port's `hub.download_example_images` against the root `hubconf.py`'s.

* The contract (tests/test_hubconf_examples.py, on the CPU): the folder holds
  frame_0000.png ... at 1920x1080 and meta.json (n_frames, fps, pos3d_world_m,
  ball_px_1920x1080), the call returns the folder, and a second call leaves it as it is.
* The frames against JAX's: JAX's `download_example_images` writes its rally; the port's
  `example_rally` renders the same rally from JAX's store (the JAX datagen's 64
  trajectories, captured from that call), JAX's camera and frame-rate draws
  (PRNGKey(seed + 1)) and JAX's sensor noise (PRNGKey(seed + 2)). The uint8 frames are
  equal but for knife-edge pixels: at most 1e-4 of the pixels differ
  (tests/test_torch_render_rally.py's limit; both write lossless PNGs; 24 of 6,220,800
  here). meta.json: the 3D positions, the
  spin and the frame count equal, fps within 1e-6 relative, the ball pixels within
  1e-2 px (tests/test_torch_synthetic.py's projection limit).
"""
import json
import os

import jax
import numpy as np
import torch

import hubconf
from upliftingtabletennis_tpu.data import datagen as JDG
from upliftingtabletennis_tpu.data import synthetic as JSYN
from upliftingtabletennis_torch import hub
from upliftingtabletennis_torch.data import synthetic as SYN
from upliftingtabletennis_torch.data.png import read_png

torch.set_num_threads(2)
KNIFE_EDGE_SHARE, PX_ATOL = 1e-4, 1e-2


def test_contract_on_the_cpu(tmp_path, capsys):
    folder = str(tmp_path / "examples")
    assert hub.download_example_images(folder, n_frames=3, device="cpu") == folder
    pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    assert pngs == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    img = read_png(os.path.join(folder, pngs[0]))
    assert img.shape == (1080, 1920, 3) and img.dtype == np.uint8
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    assert meta["n_frames"] == 3 and meta["fps"] > 0
    assert np.isfinite(np.asarray(meta["pos3d_world_m"])).all()
    assert np.asarray(meta["pos3d_world_m"]).shape == (3, 3)
    assert np.asarray(meta["ball_px_1920x1080"]).shape == (3, 2)
    mtimes = {p: os.path.getmtime(os.path.join(folder, p)) for p in pngs}
    assert hub.download_example_images(folder, n_frames=3, device="cpu") == folder
    assert "Skipping generation" in capsys.readouterr().out
    for p in pngs:
        assert os.path.getmtime(os.path.join(folder, p)) == mtimes[p]


def test_frames_match_jax_from_its_store_and_draws(tmp_path, monkeypatch):
    captured = {}
    real = JDG.generate_dataset

    def capture(*args, **kw):
        captured["res"] = real(*args, **kw)
        return captured["res"]

    monkeypatch.setattr(JDG, "generate_dataset", capture)
    folder = str(tmp_path / "jax")
    hubconf.download_example_images(folder, n_frames=3, seed=0)
    with open(os.path.join(folder, "meta.json")) as f:
        want_meta = json.load(f)
    want = np.stack([read_png(os.path.join(folder, f"frame_{i:04d}.png")) for i in range(3)])

    store = SYN.store_to_device(SYN.store_from_datagen(captured["res"]), "cpu")
    k_fps, k_cam = jax.random.split(jax.random.PRNGKey(1))
    fps = np.array(jax.random.randint(k_fps, (1,), JSYN.FPS_BOUNDS[0], JSYN.FPS_BOUNDS[1] + 1))
    cam = np.stack([np.array(jax.random.uniform(k, (1, JSYN.NUM_CAMERA_TRIES)))
                    for k in jax.random.split(k_cam, 11)])
    draws = SYN.BatchDraws(torch.from_numpy(fps).long(), torch.from_numpy(cam))
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(2),
                                                          (3, 1080, 1920))))
    frames, meta = hub.example_rally(store, 3, draws, noise)
    got = frames.numpy()
    assert got.shape == want.shape == (3, 1080, 1920, 3)
    differ = np.any(got != want, axis=-1)
    print(f"{int(differ.sum())} of {differ.size} pixels differ")
    assert differ.mean() <= KNIFE_EDGE_SHARE
    assert meta["n_frames"] == want_meta["n_frames"] == 3
    assert abs(meta["fps"] - want_meta["fps"]) <= 1e-6 * want_meta["fps"]
    for k in ("pos3d_world_m", "spin_rad_s"):
        np.testing.assert_array_equal(np.float32(meta[k]), np.float32(want_meta[k]), k)
    np.testing.assert_allclose(meta["ball_px_1920x1080"], want_meta["ball_px_1920x1080"],
                               atol=PX_ATOL, rtol=0)
