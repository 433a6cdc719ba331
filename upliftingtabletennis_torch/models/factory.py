"""Detector factory and per-model native input resolutions.

Port of `upliftingtabletennis_tpu/models/factory.py`: SegFormer b0/b2 (ball
and table), ViTPose (ball and table), WASB (HRNet, ball only) and HRNet
(table only).
"""
from __future__ import annotations

from upliftingtabletennis_torch.models.hrnet import TableHRNet, WASBNet
from upliftingtabletennis_torch.models.segformer import SegFormerNet
from upliftingtabletennis_torch.models.vit import VitPoseNet

# (W, H) native input resolutions (ref: models/factory.py:16 of the JAX package)
DETECTOR_RESOLUTIONS = {
    "segformerpp_b0": (1920, 1088),
    "segformerpp_b2": (1600, 896),
    "vitpose": (1152, 640),
    "wasb": (1280, 704),
    "hrnet": (1280, 704),
}

# the detectors of each task (ref: models/factory.py:24-25 of the JAX package)
BALL_MODELS = ("segformerpp_b0", "segformerpp_b2", "vitpose", "wasb")
TABLE_MODELS = ("segformerpp_b0", "segformerpp_b2", "vitpose", "hrnet")


def get_detector(name: str, task: str = "ball", in_frames: int = None,
                 classify_invisible: bool = False, head_style: str = "nvlabs",
                 decoder_dim: int = 0, kernels: bool = True, resolution=None,
                 train: bool = False, remat: bool = False):
    """Build a detector. Returns (model, (W, H) input resolution).

    task 'ball': 3-frame input, 1 heatmap channel; 'table': 1 frame, 13 channels.
    resolution: (W, H) in place of the model's native one; ViTPose is built for it
    (its position embedding has one row per patch), at the "small" width, as the
    JAX package's factory builds it. The SegFormer options (classify_invisible,
    head_style, decoder_dim) apply to SegFormer only. kernels=False runs the
    plain versions of the model's kernels, and ViTPose's attention in its einsum
    form in place of `F.scaled_dot_product_attention` (for comparisons only).
    train=True builds the model in training mode: a SegFormer's head BatchNorms, and
    every BatchNorm of WASB and the table HRNet, on batch statistics. remat (the HRNet
    family, as in the JAX factory) checkpoints each HRNet block; SegFormer ignores it,
    as the JAX factory does. ViTPose's trainer is not ported yet.
    """
    if task not in ("ball", "table"):
        raise ValueError(f"unknown task {task!r}")
    if name not in DETECTOR_RESOLUTIONS:
        raise ValueError(f"unknown detector {name!r}")
    res = tuple(resolution) if resolution is not None else DETECTOR_RESOLUTIONS[name]
    out_channels = 1 if task == "ball" else 13
    frames = in_frames if in_frames is not None else (3 if task == "ball" else 1)
    is_segformer = name in ("segformerpp_b0", "segformerpp_b2")
    if train and name == "vitpose":
        raise ValueError("training 'vitpose' is not ported yet (ROADMAP queue 1 item 5a: "
                         "stochastic depth and the head's BatchNorms on batch statistics)")
    if is_segformer:
        model = SegFormerNet(out_channels, frames, name.split("_")[1], classify_invisible,
                             head_style=head_style, decoder_dim=decoder_dim, kernels=kernels,
                             train=train)
    elif name == "vitpose":
        model = VitPoseNet(out_channels, frames, "small", res, sdpa=kernels)
    elif name == "wasb":
        if task != "ball":
            raise ValueError("wasb is a ball detector (task='ball')")
        model = WASBNet(frames, kernels=kernels, train=train, remat=remat)
    elif name == "hrnet":
        if task != "table":
            raise ValueError("hrnet is a table detector (task='table')")
        model = TableHRNet(13, kernels=kernels, train=train, remat=remat)
    else:
        raise ValueError(f"unknown detector {name!r}")
    return model, res
