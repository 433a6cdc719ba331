"""One detector training step, in one process or as one rank of a gloo group (no JAX).

`step(case, shard)` runs a case from `tests/test_torch_parallel.py` and returns its loss,
gradients (by parameter name) and buffers; `run(rank, world, port, spec, out)` is the
entry point of `torch.multiprocessing.spawn`: it joins the gloo group at
127.0.0.1:port, runs every case of the spec file on this rank's slice of the batch under
`DistributedDataParallel`, with the BatchNorm statistics shared over the group, and saves
the results to `<out>/rank<r>.pt`.

A case: {"name", "model", "task", "resolution" (W, H), "state" (a state dict), "batch"
(the global batch), "kind", "dtype" (of the model and its input; f32 by default)}, and for
"train_step" {"images", "coords", "vis", "eval_res", "seed"} (one `run_detection.train_step`
with the trainer's draws), for "loss_step" {"imgs", "target", "masks"} (the trainer's
`loss_fn` on given model inputs and drop masks; masks None for a model without them).
"""
import torch

from upliftingtabletennis_torch.data.image_transforms import ImageAugmentConfig
from upliftingtabletennis_torch.models import batch_norm as BN
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.parallel import distributed as D
from upliftingtabletennis_torch.train import run_detection as T


def step(case, shard=None):
    model, _ = get_detector(case["model"], case["task"], resolution=case["resolution"],
                            train=True, remat=True, kernels=False)
    model.load_state_dict(case["state"])
    dtype = case.get("dtype", torch.float32)
    model.to(dtype)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    net = model
    if shard is not None:
        from torch.nn.parallel import DistributedDataParallel

        BN.sync_batch_stats(model)
        net = DistributedDataParallel(model, broadcast_buffers=False,
                                      find_unused_parameters=case["model"] in ("wasb", "hrnet"))
    sl = slice(None) if shard is None else shard[0]
    if case["kind"] == "train_step":
        captured = {}
        update = T.apply_update

        def keep(params_, grads, *a, **k):
            captured["grads"] = [g.detach().clone() for g in grads]
            return update(params_, grads, *a, **k)

        T.apply_update = keep
        try:
            opt, ema = T.init_adam(params), [p.detach().clone() for p in params]
            gen = torch.Generator().manual_seed(case["seed"])
            loss = T.train_step(net, params, opt, ema, gen, case["images"][sl],
                                case["coords"][sl], case["vis"][sl], case["resolution"],
                                case["eval_res"], ImageAugmentConfig(), dtype=dtype,
                                shard=shard)
        finally:
            T.apply_update = update
        grads = captured["grads"]
    else:
        masks = case["masks"]
        loss, _ = T.loss_fn(net, case["imgs"][sl].to(dtype), case["target"][sl],
                            None if masks is None else masks[:, :, sl])
        if shard is None:
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        else:
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            loss = D.all_reduce_mean(loss.detach())
    return {"loss": loss.item(), "grads": dict(zip(names, [g.detach() for g in grads])),
            "buffers": {k: v.detach().clone() for k, v in model.named_buffers()}}


def run(rank, world, port, spec, out):
    torch.set_num_threads(2)
    D.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        cases = torch.load(spec, weights_only=False)
        res = {c["name"]: step(c, (D.local_batch_slice(c["batch"]), c["batch"])) for c in cases}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        D.shutdown()
