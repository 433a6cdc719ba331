"""Multi-process initialisation and rank-aware helpers over `torch.distributed`.

Port of `upliftingtabletennis_tpu/parallel/distributed.py`. Where the JAX package wires
`jax.distributed` and lets jit partition the step, the port runs one process per card
and joins them in a `torch.distributed` process group: NCCL for CUDA devices, gloo for
the CPU. The launcher is read from the environment:

* torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` (and `LOCAL_RANK`
  for the card of the process), or
* the JAX package's `COORDINATOR_ADDRESS` (host:port), `NUM_PROCESSES` and `PROCESS_ID`;

explicit arguments win over both. A single-process run is a no-op throughout, so the
same scripts run unchanged on one card or several.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Optional, TypeVar

import torch

Fn = TypeVar("Fn", bound=Callable)

__all__ = ["initialize_multihost", "shutdown", "process_index", "process_count",
           "is_main_process", "main_process_only", "local_batch_slice", "local_device",
           "all_reduce_mean"]


def _env_int(*names) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group of a multi-process run. Returns True when this call
    initialised it, False for a single-process run or a group already initialised.

    coordinator_address "host:port" (else `COORDINATOR_ADDRESS`; else torchrun's store at
    `MASTER_ADDR` / `MASTER_PORT`, by `env://`); num_processes (else `NUM_PROCESSES` / `WORLD_SIZE`);
    process_id (else `PROCESS_ID` / `RANK`). `device`: the backend follows it, NCCL for
    CUDA and gloo otherwise; a CUDA process binds the card `LOCAL_RANK` names."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    num_processes = num_processes if num_processes is not None else _env_int(
        "NUM_PROCESSES", "WORLD_SIZE")
    if not num_processes or num_processes <= 1:
        return False
    process_id = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no rank: set PROCESS_ID or RANK")
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR"):
        init_method = "env://"  # torchrun's store
    else:
        raise ValueError(f"{num_processes} processes but no coordinator: set "
                         "COORDINATOR_ADDRESS or MASTER_ADDR / MASTER_PORT")
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def shutdown() -> None:
    """Leave the process group (after the last collective)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def local_device(device) -> torch.device:
    """The card of this process in a multi-process CUDA run (`LOCAL_RANK`), else
    `device` as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and process_count() > 1:
        return torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return device


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the processes (a copy; `t` itself when single-process)."""
    if process_count() == 1:
        return t
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out)
    return out / process_count()


def is_main_process() -> bool:
    """True on exactly one process: gate logging and checkpoint writes with it."""
    return process_index() == 0


def main_process_only(fn: Fn) -> Fn:
    """Decorator: run `fn` on process 0 only (None elsewhere)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


def local_batch_slice(global_batch: int) -> slice:
    """This process's shard of a globally indexed batch (contiguous, equal shares)."""
    n, i = process_count(), process_index()
    if global_batch % n != 0:
        raise ValueError(f"batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
