"""Self-describing checkpoints of the port: a torch state dict with its metadata beside it.

Counterpart of `upliftingtabletennis_tpu/utils/checkpoint.py` (`save_checkpoint`,
`load_checkpoint`), which writes Orbax directories. Here `path` is a `torch.save` file of
the state dict alone, which `BallDetector(..., checkpoint=path)` and
`TableDetector(..., checkpoint=path)` load (`weights_only=True`), and `path + ".json"`
holds `{"identifier", "additional_info"}` (the reference's checkpoint contract: the
hyperparameters that rebuild the architecture). `load_model_from_checkpoint` rebuilds the
uplifting model from them (`name`, `size`, `tabletoken_mode`, `time_rotation`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_model_from_checkpoint"]


def _meta_path(path: str) -> str:
    return path + ".json"


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor], identifier: str,
                    info: Dict[str, Any]) -> None:
    """Write the state dict (as CPU tensors) to `path` and its metadata to `path.json`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(_meta_path(path), "w") as f:
        json.dump({"identifier": identifier, "additional_info": info}, f, indent=2)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], str, Dict[str, Any]]:
    """(state_dict, identifier, info) of a checkpoint written by `save_checkpoint`."""
    path = os.path.abspath(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    return state, meta.get("identifier", ""), meta.get("additional_info", {})


def load_model_from_checkpoint(path: str):
    """(model, state_dict, identifier, info) of an uplifting checkpoint: the model built
    from `info` and loaded with the state dict, in eval mode on the CPU."""
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model

    state, identifier, info = load_checkpoint(path)
    model = get_uplifting_model(name=info.get("name", "connectstage"),
                                size=info.get("size", "large"),
                                mode=info.get("tabletoken_mode", "dynamic"),
                                time_rotation=info.get("time_rotation", "new"))
    model.load_state_dict(state)
    return model.eval(), state, identifier, info
