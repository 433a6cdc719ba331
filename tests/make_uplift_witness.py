"""Make `tests/uplift_witness_60.npz`: the JAX uplifting trainer's 60 steps on one batch,
recorded for the port.

tests/test_data_pipeline.py::test_train_step_reduces_loss, reproduced: 24 "intermediate"
trajectories from the JAX `generate_dataset` (PRNGKey 1, batch 128), one validation batch
of 16 (`assemble_batch(PRNGKey(0), ..., train=False)` + `eval_augment`), connectstage
small initialised by `create_train_state` (PRNGKey 0), 60 steps of `make_train_step` at lr
1e-3. The file keeps the batch's six fields, the initial parameters as the port's state
dict (`flax_to_torch`, keys `param.<name>`) and JAX's 60 losses. `chip_smoke.py` (phase
`uplift_train`, gate 3) runs the port's 60 steps on the card from them;
`tests/test_torch_uplifting_train.py` checks the file against the JAX package and the
port's CPU steps against its losses.

Then, for the record, the same 60 steps at full width (large, batch 64, on
tests/uplift_data.py's analytic flights) from the same JAX weights, four times: JAX; JAX
from those weights moved up by one ulp in a seeded half of the entries (how far f32
training at lr 1e-3 carries one rounding); the port in f32; the port in float64 (the
referee). It prints the first step's loss and gradients (port against JAX and both
against float64, the gradient entries whose signs differ: Adam's first step moves each
entry by lr in its gradient's sign), each run's loss ratio last / first, and the per-step
loss gaps of each pair: the first 5 steps, the largest, and the first step beyond 1e-3.
Run from the repository root (about 20 min on the CPU; `--record-only` skips rewriting the
witness file):

    JAX_PLATFORMS=cpu python tests/make_uplift_witness.py [--record-only]
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "uplift_witness_60.npz")
STEPS, LR, B = 60, 1e-3, 16
FIELDS = ("ball_img", "table_img", "mask", "r_world", "rotation", "times")


def jax_steps(model, state, step, batch):
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return np.asarray(losses)


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from uplift_data import analytic_datagen
    from upliftingtabletennis_tpu.data import augment as JA
    from upliftingtabletennis_tpu.data import datagen as JDG
    from upliftingtabletennis_tpu.data import synthetic as JSYN
    from upliftingtabletennis_tpu.models import get_uplifting_model as jax_model
    from upliftingtabletennis_tpu.train import uplifting_train as JUT
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
    from upliftingtabletennis_torch.train import uplifting_train as UT
    from upliftingtabletennis_torch.utils.convert import flax_to_torch

    def batch_of(store, idx):
        s = JA.eval_augment(JSYN.assemble_batch(jax.random.PRNGKey(0), store, idx, train=False))
        return JUT.Batch(s["r_img"], s["table_img"], s["mask"], s["r_world"], s["rotation"],
                         s["times"])

    if "--record-only" not in sys.argv:
        write_witness(jax, jnp, JDG, JSYN, JUT, jax_model, flax_to_torch, batch_of)
    full_width_record(jax, jnp, torch, JSYN, JUT, UT, jax_model, get_uplifting_model,
                      flax_to_torch, analytic_datagen, batch_of)


def write_witness(jax, jnp, JDG, JSYN, JUT, jax_model, flax_to_torch, batch_of):
    res = JDG.generate_dataset(jax.random.PRNGKey(1), 24, "intermediate", "left_to_right",
                               batch=128)
    store = jax.tree.map(jnp.asarray, JSYN.store_from_datagen(res))
    batch = batch_of(store, jnp.arange(B) % len(store.rotations))
    model = jax_model("connectstage", "small", mode="dynamic")
    state, tx = JUT.create_train_state(model, jax.random.PRNGKey(0), batch, lr=LR)
    params = flax_to_torch({"params": jax.device_get(state.params)})
    losses = jax_steps(model, state, JUT.make_train_step(model, tx), batch)
    np.savez(OUT, losses=losses, **{f: np.asarray(getattr(batch, f)) for f in FIELDS},
             **{f"param.{k}": v.numpy() for k, v in params.items()})
    print(f"wrote {OUT}: JAX's loss {losses[0]:.2f} -> {losses[-1]:.2f} "
          f"({losses[-1] / losses[0]:.4f})", flush=True)


def gaps(name, got, want):
    rel = np.abs(got - want) / want
    beyond = np.nonzero(rel > 1e-3)[0]
    print(f"  {name}: steps 1-5 {np.array2string(rel[:5], precision=2)}, largest "
          f"{rel.max():.2e} (step {rel.argmax() + 1}), first beyond 1e-3: "
          f"{beyond[0] + 1 if len(beyond) else 'none'}", flush=True)


def full_width_record(jax, jnp, torch, JSYN, JUT, UT, jax_model, get_uplifting_model,
                      flax_to_torch, analytic_datagen, batch_of):
    import copy

    store = jax.tree.map(jnp.asarray, JSYN.store_from_datagen(analytic_datagen(64, seed=1)))
    batch = batch_of(store, jnp.arange(64))
    model = jax_model("connectstage", "large", mode="dynamic")
    state, tx = JUT.create_train_state(model, jax.random.PRNGKey(0), batch, lr=LR)
    p0 = jax.device_get(state.params)
    port = get_uplifting_model(size="large")
    port.load_state_dict(flax_to_torch({"params": p0}))
    exact = copy.deepcopy(port).double()
    tb = UT.Batch(*(torch.tensor(np.asarray(a)) for a in batch))
    tb64 = UT.Batch(*(t.double() if t.is_floating_point() else t for t in tb))

    # the first step's gradients
    (loss_j, _), gj = jax.jit(jax.value_and_grad(
        lambda p: JUT.loss_fn(model, p, batch, "global"), has_aux=True))(state.params)
    gj = flax_to_torch({"params": jax.device_get(gj)})
    gj = [gj[n] for n, _ in port.named_parameters()]
    loss, _ = UT.loss_fn(port, tb)
    gp = torch.autograd.grad(loss, list(port.parameters()))
    loss64, _ = UT.loss_fn(exact, tb64)
    ge = torch.autograd.grad(loss64, list(exact.parameters()))

    def worst(a, b):
        return max(float((x.double() - y.double()).abs().max()
                         / y.double().abs().max().clamp_min(1e-300)) for x, y in zip(a, b))

    signs = sum(int((torch.sign(x) != torch.sign(y)).sum()) for x, y in zip(gp, gj))
    print(f"full width (large, batch 64), step 1: loss port {loss.item()!r} JAX "
          f"{float(loss_j)!r}; each gradient's largest gap over its max: port-JAX "
          f"{worst(gp, gj):.2e}, port-f64 {worst(gp, ge):.2e}, JAX-f64 {worst(gj, ge):.2e}; "
          f"signs differing port-JAX {signs} of {sum(x.numel() for x in gp)}", flush=True)

    step = JUT.make_train_step(model, tx)
    want = jax_steps(model, state, step, batch)
    rng = np.random.default_rng(0)
    up = jax.tree.map(lambda a: np.where(rng.random(a.shape) < 0.5,
                                         np.nextafter(a, np.float32(np.inf)), a), p0)
    up = jax.tree.map(jnp.asarray, up)
    ulp = jax_steps(model, state._replace(params=up, ema_params=up), step, batch)
    st = UT.init_train_state(port)
    got = np.asarray([float(UT.train_step(port, st, tb, LR)["loss"]) for _ in range(STEPS)])
    st = UT.init_train_state(exact)
    ref = np.asarray([float(UT.train_step(exact, st, tb64, LR)["loss"])
                      for _ in range(STEPS)])
    print("loss ratio last / first: " + ", ".join(
        f"{k} {v[-1] / v[0]:.4f}" for k, v in (("JAX", want), ("JAX 1 ulp", ulp),
                                               ("port", got), ("port f64", ref))), flush=True)
    print("per-step loss gaps, relative:")
    gaps("port against JAX", got, want)
    gaps("JAX 1 ulp against JAX", ulp, want)
    gaps("port against f64", got, ref)
    gaps("JAX against f64", want, ref)


if __name__ == "__main__":
    main()
