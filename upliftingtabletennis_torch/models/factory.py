"""Detector factory and per-model native input resolutions.

Port of `upliftingtabletennis_tpu/models/factory.py` for the models the port
covers: SegFormer b0/b2 (ball and table), WASB (HRNet, ball only) and HRNet
(table only). ViTPose is a later slice and raises NotImplementedError naming
its ROADMAP item.
"""
from __future__ import annotations

from upliftingtabletennis_torch.models.hrnet import TableHRNet, WASBNet
from upliftingtabletennis_torch.models.segformer import SegFormerNet

# (W, H) native input resolutions (ref: models/factory.py:16 of the JAX package)
DETECTOR_RESOLUTIONS = {
    "segformerpp_b0": (1920, 1088),
    "segformerpp_b2": (1600, 896),
    "vitpose": (1152, 640),
    "wasb": (1280, 704),
    "hrnet": (1280, 704),
}

_NOT_PORTED = {"vitpose": "ROADMAP queue 1, item 1 (models/vit.py)"}


def get_detector(name: str, task: str = "ball", in_frames: int = None,
                 classify_invisible: bool = False, head_style: str = "nvlabs",
                 decoder_dim: int = 0, kernels: bool = True):
    """Build a detector. Returns (model, (W, H) native resolution).

    task 'ball': 3-frame input, 1 heatmap channel; 'table': 1 frame, 13 channels.
    The SegFormer options (classify_invisible, head_style, decoder_dim) do not
    apply to the HRNet models. kernels=False runs the plain versions of the
    model's kernels (for comparisons only).
    """
    if task not in ("ball", "table"):
        raise ValueError(f"unknown task {task!r}")
    if name in _NOT_PORTED:
        raise NotImplementedError(f"detector {name!r} is not ported yet: {_NOT_PORTED[name]}")
    out_channels = 1 if task == "ball" else 13
    frames = in_frames if in_frames is not None else (3 if task == "ball" else 1)
    if name in ("segformerpp_b0", "segformerpp_b2"):
        model = SegFormerNet(out_channels, frames, name.split("_")[1], classify_invisible,
                             head_style=head_style, decoder_dim=decoder_dim, kernels=kernels)
    elif name == "wasb":
        if task != "ball":
            raise ValueError("wasb is a ball detector (task='ball')")
        model = WASBNet(frames, kernels=kernels)
    elif name == "hrnet":
        if task != "table":
            raise ValueError("hrnet is a table detector (task='table')")
        model = TableHRNet(13, kernels=kernels)
    else:
        raise ValueError(f"unknown detector {name!r}")
    return model, DETECTOR_RESOLUTIONS[name]
