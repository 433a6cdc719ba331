"""One uplifting trainer step, in one process or as one rank of a gloo group (no JAX).

`step(spec, shard, fault)` runs `train/uplifting_train.train_step` from the spec's state
dict on its global batch (or on this rank's slice under `DistributedDataParallel`) and
returns the loss terms, the gradients that reached `apply_update` and the parameters
after it; `run(rank, world, port, spec, out)` is the entry point of
`torch.multiprocessing.spawn`: it joins the gloo group at 127.0.0.1:port, runs the step
and, with the spec's "fault", the step again with each rank dividing by its own
sum(mask), and saves both to `<out>/rank<r>.pt`.

A spec: {"state" (a state dict of connectstage small), "batch" (the Batch fields of the
global batch), "dtype", "lr", "ema_decay", "transform_mode"}.
"""
import torch

from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.parallel import distributed as D
from upliftingtabletennis_torch.train import uplifting_train as UT


def step(spec, shard=None, fault=False):
    model = get_uplifting_model("connectstage", "small", "dynamic", "new")
    model.load_state_dict(spec["state"])
    model.to(spec["dtype"])
    state = UT.init_train_state(model)
    sl = slice(None) if shard is None else shard
    batch = UT.Batch(**{k: v[sl].to(spec["dtype"]) for k, v in spec["batch"].items()})
    ddp = None
    if shard is not None:
        from torch.nn.parallel import DistributedDataParallel

        ddp = DistributedDataParallel(model, broadcast_buffers=False)
    captured, update, total = {}, UT.apply_update, D.all_reduce_sum
    calls = []

    def keep(state_, grads, *a, **k):
        captured["grads"] = [g.detach().clone() for g in grads]
        return update(state_, grads, *a, **k)

    def local_mask_sum(t):  # the planted fault: the first global sum is the mask's
        calls.append(1)
        return t.detach().clone() if len(calls) == 1 else total(t)

    UT.apply_update = keep
    if fault:
        D.all_reduce_sum = local_mask_sum
    try:
        m = UT.train_step(model, state, batch, spec["lr"], spec["ema_decay"],
                          spec["transform_mode"], ddp)
    finally:
        UT.apply_update, D.all_reduce_sum = update, total
    names = [n for n, _ in model.named_parameters()]
    return {"loss": {k: v.item() for k, v in m.items()},
            "grads": dict(zip(names, captured["grads"])),
            "params": {n: p.detach().clone() for n, p in zip(names, state.params)}}


def run(rank, world, port, spec, out):
    torch.set_num_threads(1)
    D.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        spec = torch.load(spec, weights_only=False)
        shard = D.local_batch_slice(spec["batch"]["mask"].shape[0])
        res = {"ddp": step(spec, shard), "fault": step(spec, shard, fault=True)}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        D.shutdown()
