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
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Union

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
    `weights_root` (WEIGHTS_LAYOUT) are overridden by `checkpoints`."""
    if weights_url is not None:
        raise NotImplementedError("weights_url needs the network and the reference's weight "
                                  "port; it is not ported (ROADMAP queue 1, item 7): convert "
                                  "the weights once and pass weights_root")
    ck = {}
    if weights_root is not None:
        for key, rel in WEIGHTS_LAYOUT.items():
            path = os.path.join(weights_root, rel)
            if os.path.isfile(path):
                ck[key] = path
    ck.update(checkpoints or {})
    return TableTennisPipeline(ck, device=device, **kw)
