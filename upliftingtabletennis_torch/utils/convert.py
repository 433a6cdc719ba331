"""Weights carried across from the JAX package.

`flax_to_torch` maps the JAX package's `{"params", "batch_stats"}` tree
(numpy arrays) to a state dict of the port's modules, which are named after
the flax tree, so the map is a path walk with these transforms:

    conv kernel HWIO          -> weight OIHW (depthwise (3, 3, 1, C) -> (C, 1, 3, 3))
    Dense kernel (in, out)    -> weight (out, in)
    ConvTranspose kernel      -> weight: flax `transpose_kernel=True` stores
                                 (kh, kw, out, in); the same 4-D rule gives torch's
                                 (in, out, kh, kw), with no spatial flip
    LayerNorm/BatchNorm scale -> weight
    pos_embed (ViTPose)       -> pos_embed, as it is
    cls_token (uplifting)     -> cls_token, as it is
    batch_stats mean / var    -> running_mean / running_var (+ num_batches_tracked)

Reading the committed Orbax checkpoints needs the JAX package, so the
conversion runs wherever it is installed; the result can be saved with
`torch.save` and loaded with no JAX at all.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flax_to_torch"]


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of numpy arrays -> torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables.get("params", {})):
        a = np.asarray(leaf, dtype=np.float32)
        *mod, name = path
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name not in ("bias", "pos_embed", "cls_token"):
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        sd[".".join(mod + [name])] = torch.from_numpy(np.array(a, dtype=np.float32))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch statistic {'/'.join(path)}")
        key = ".".join(mod)
        sd[f"{key}.running_{name}"] = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd
