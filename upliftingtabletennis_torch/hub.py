"""Hub-style entry points of the port (counterpart of the root `hubconf.py`)."""
from __future__ import annotations

from typing import Mapping, Union

from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector


def ball_detection(model_name: str = "segformerpp_b2",
                   checkpoint: Union[None, str, Mapping] = None, device="cuda", **kw):
    """Ball detector on `device` (CUDA unless the caller asks for the CPU)."""
    return BallDetector(model_name, checkpoint, device=device, **kw)


def table_detection(model_name: str = "segformerpp_b2",
                    checkpoint: Union[None, str, Mapping] = None, device="cuda", **kw):
    """Table keypoint detector on `device` (CUDA unless the caller asks for the CPU)."""
    return TableDetector(model_name, checkpoint, device=device, **kw)
