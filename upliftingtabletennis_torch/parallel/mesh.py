"""A named ('dp', 'mp') grid of devices, and the batch and weight placement over it.

Port of `upliftingtabletennis_tpu/parallel/mesh.py`. JAX lays a `jax.sharding.Mesh`
over its devices and lets jit partition a program over it; the port's `Mesh` is the
same grid of `torch.device`s, and its users run one piece of the work per 'dp' device
themselves: `shard_batch` splits dim 0 over the dp axis, `replicate` puts a copy of a
module or tensor on each dp device (the pipeline's sharded step uses both). The 'mp' axis
is kept for the JAX layout (`make_mesh(n_dp, n_mp)`); nothing shards over it. One process
drives every device of a mesh (the pipeline's and datagen's multi-card paths);
multi-process training is `torch.distributed` (`distributed.py`).
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["Mesh", "make_mesh", "dp_devices", "shard_batch", "replicate"]


class Mesh:
    """devices: an (n_dp, n_mp) object array of torch.device; shape {"dp": n_dp,
    "mp": n_mp}, as `jax.sharding.Mesh.shape` reads."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": int(devices.shape[0]), "mp": int(devices.shape[1])}


def make_mesh(n_dp: Optional[int] = None, n_mp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('dp', 'mp') mesh over `devices` (default: every card), dp-major; n_dp defaults
    to len(devices) // n_mp. More devices asked than given raises, as in JAX."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    # a card named without its index is the current one, as its tensors report it
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if n_dp is None:
        n_dp = len(devices) // n_mp
    if n_dp * n_mp > len(devices):
        raise ValueError(f"mesh {n_dp}x{n_mp} needs {n_dp * n_mp} devices, have {len(devices)}")
    grid = np.empty(n_dp * n_mp, dtype=object)
    for i, d in enumerate(devices[:n_dp * n_mp]):
        grid[i] = d
    return Mesh(grid.reshape(n_dp, n_mp))


def dp_devices(mesh: Mesh) -> List[torch.device]:
    """The devices along the dp axis (mp index 0), in order."""
    return [mesh.devices[i, 0] for i in range(mesh.shape["dp"])]


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch) -> list:
    """A tensor, or a dict / list / tuple of tensors (None kept), split along dim 0 into
    equal shares over the dp devices: one such structure per device, on it. The batch
    must divide."""
    devs = dp_devices(mesh)
    n = len(devs)

    def part(i):
        def take(t):
            if t.shape[0] % n:
                raise ValueError(f"batch {t.shape[0]} not divisible by the mesh's dp ({n})")
            per = t.shape[0] // n
            return t[i * per:(i + 1) * per].to(devs[i])
        return take

    return [_tree_map(part(i), batch) for i in range(n)]


def replicate(mesh: Mesh, tree) -> list:
    """One copy of a module, tensor, or dict / list / tuple of them per dp device, on it.
    A module is deep-copied to every device but the one it lies on, where it is its own
    copy, as `Tensor.to` returns the tensor itself."""
    def put(d):
        def one(x):
            if isinstance(x, torch.nn.Module):
                if all(p.device == d for p in x.parameters()):
                    return x
                return copy.deepcopy(x).to(d)
            return x.to(d) if isinstance(x, torch.Tensor) else x
        return one

    return [_tree_map(put(d), tree) for d in dp_devices(mesh)]
