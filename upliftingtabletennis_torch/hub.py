"""Hub-style entry points of the port (counterpart of the root `hubconf.py`).

Checkpoints are the port's (`utils/checkpoint.py`: a `torch.save` state dict at `path`,
its metadata at `path.json`), converted once from the JAX package's Orbax checkpoints by
`utils/convert.py:flax_to_torch`. `full_pipeline(weights_root=...)` reads the layout of
`hubconf.py`, each entry one checkpoint file:

    <weights_root>/inference_balldetection/segformerpp_b2/model
    <weights_root>/inference_balldetection/wasb/model
    <weights_root>/inference_tabledetection/segformerpp_b2/model
    <weights_root>/inference_tabledetection/hrnet/model
    <weights_root>/inference_uplifting/ours/model        (+ model.json)

`full_pipeline(weights_url=...)` takes the reference's released weights zip instead
(https:// or file://): it is downloaded and extracted once into
`~/.cache/upliftingtabletennis_torch/weights`, converted once into that layout
(`utils/port_reference_weights.fetch_and_port`), and read from the cache afterwards.

`download_example_images` renders a folder of example frames of one rally on the card
(no network): a physics rally, a sampled broadcast camera and the closed loop's renderer.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Union

import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.pipeline.interface import (BallDetector, TableDetector,
                                                           TableTennisPipeline, UpliftingModel)

WEIGHTS_LAYOUT = {
    "ball_main": "inference_balldetection/segformerpp_b2/model",
    "ball_aux": "inference_balldetection/wasb/model",
    "table_main": "inference_tabledetection/segformerpp_b2/model",
    "table_aux": "inference_tabledetection/hrnet/model",
    "uplifting": "inference_uplifting/ours/model",
}


def ball_detection(model_name: str = "segformerpp_b2",
                   checkpoint: Union[None, str, Mapping] = None, device="cuda", **kw):
    """Ball detector on `device` (CUDA unless the caller asks for the CPU)."""
    return BallDetector(model_name, checkpoint, device=device, **kw)


def table_detection(model_name: str = "segformerpp_b2",
                    checkpoint: Union[None, str, Mapping] = None, device="cuda", **kw):
    """Table keypoint detector on `device` (CUDA unless the caller asks for the CPU)."""
    return TableDetector(model_name, checkpoint, device=device, **kw)


def uplifting(checkpoint: Union[None, str, Mapping] = None, device="cuda", **kw):
    """2D -> 3D uplifting model on `device`."""
    return UpliftingModel(checkpoint, device=device, **kw)


def full_pipeline(checkpoints: Optional[dict] = None, weights_root: Optional[str] = None,
                  weights_url: Optional[str] = None, device="cuda", **kw):
    """The whole video -> 3D and spin pipeline on `device`. Checkpoints found under
    `weights_root` (WEIGHTS_LAYOUT), or else under the conversion of the reference's
    weights zip at `weights_url` (`fetch_and_port`, cached), are overridden by
    `checkpoints`; a slot with no checkpoint gets seeded random weights."""
    if weights_url is not None and weights_root is None:
        from upliftingtabletennis_torch.utils.port_reference_weights import fetch_and_port

        weights_root = fetch_and_port(weights_url)
    ck = {}
    if weights_root is not None:
        for key, rel in WEIGHTS_LAYOUT.items():
            path = os.path.join(weights_root, rel)
            if os.path.isfile(path):
                ck[key] = path
    ck.update(checkpoints or {})
    return TableTennisPipeline(ck, device=device, **kw)


EXAMPLE_W, EXAMPLE_H = 1920, 1080  # the pipeline's working resolution


def example_rally(store, n_frames: int = 40, draws=None, noise=None,
                  generator: Optional[torch.Generator] = None):
    """Trajectory 0 of `store` (a TrajectoryStore on the device) as an example rally:
    (frames (T, 1080, 1920, 3) uint8 on the device, meta), T at most n_frames. Its
    camera and frame rate are drawn as the uplifting trainer draws them (`draws`, a
    `synthetic.BatchDraws` for one trajectory, or from `generator`), and the frames are
    rendered by `render_rally.render_frames` with sensor noise `noise` (T, 1080, 1920)
    or from `generator`. meta: fps, n_frames, ball_px_1920x1080 (T, 2), pos3d_world_m
    (T, 3) and spin_rad_s (3,), the simulation's truth."""
    from upliftingtabletennis_torch.core.geometry import HEIGHT as UPL_H, WIDTH as UPL_W
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.render_rally import (project_context, render_frames,
                                                               rescale_px)

    dev = store.blur_positions.device
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    if draws is None:
        draws = SYN.draw_batch(1, True, generator, dev)
    sample = SYN.assemble_batch_from_draws(store, idx, draws, train=True)
    mask = sample["mask"][0]
    T = min(int(mask.sum()), n_frames)
    up, ev = (UPL_W, UPL_H), (EXAMPLE_W, EXAMPLE_H)
    ball_eval = rescale_px(sample["r_img"][0], up, ev).to(dev)
    table_eval = rescale_px(sample["table_img"][0][:, :2], up, ev).to(dev)
    ctx_eval = rescale_px(project_context(sample["Mint"][0], sample["Mext"][0]), up, ev).to(dev)
    frames = render_frames(ball_eval[:T], mask[:T], table_eval, EXAMPLE_H, EXAMPLE_W, ctx_eval,
                           noise=noise, generator=generator)
    times = sample["times"][0][:T].cpu().numpy()
    meta = {"fps": 1.0 / max(float(times[1] - times[0]), 1e-6), "n_frames": int(T),
            "ball_px_1920x1080": ball_eval[:T].cpu().numpy().tolist(),
            "pos3d_world_m": sample["r_world"][0][:T].cpu().numpy().tolist(),
            "spin_rad_s": sample["rotation"][0].cpu().numpy().tolist()}
    return frames, meta


def download_example_images(local_folder: str = "example_images", n_frames: int = 40,
                            seed: int = 0, device="cuda") -> str:
    """A folder of example frames to run the pipeline on: `frame_0000.png`, ... of one
    rally at 1920x1080 and `meta.json` (fps, n_frames, the ball's pixels, the 3D
    positions and the spin of the simulation), rendered locally on `device` (the card
    unless the caller asks for the CPU) with no network. Idempotent: a folder that
    already holds files is left as it is. Returns the folder.

    64 intermediate trajectories are generated from seed `seed` (`datagen`), and
    trajectory 0 is projected through a camera drawn from seed + 1 and rendered with
    sensor noise from seed + 2 (`example_rally`)."""
    if os.path.isdir(local_folder) and len(os.listdir(local_folder)) > 0:
        print(f"Images already present in '{local_folder}'. Skipping generation.")
        return local_folder
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.png import write_png

    dev = resolve_device(device)
    res = DG.generate_dataset(64, "intermediate", "left_to_right",
                              generator=torch.Generator(device=dev).manual_seed(seed),
                              device=dev)
    store = SYN.store_to_device(SYN.store_from_datagen(res), dev)
    draws = SYN.draw_batch(1, True, torch.Generator(device=dev).manual_seed(seed + 1), dev)
    frames, meta = example_rally(store, n_frames, draws,
                                 generator=torch.Generator(device=dev).manual_seed(seed + 2))
    os.makedirs(local_folder, exist_ok=True)
    for i, frame in enumerate(frames.cpu().numpy()):
        write_png(os.path.join(local_folder, f"frame_{i:04d}.png"), frame)
    with open(os.path.join(local_folder, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"Generated {meta['n_frames']} example frames in '{local_folder}'.")
    return local_folder
