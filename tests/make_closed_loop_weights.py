"""Convert the committed closed-loop checkpoints to port checkpoints, once, on the CPU.

The JAX package's Orbax checkpoints of the closed loop's detectors and of the
back-view uplifting model (`artifacts/`, which the card does not receive) become port
checkpoints (`utils/checkpoint.py:save_checkpoint`: a `torch.save` state dict and its
`.json`) under `upliftingtabletennis_torch/weights/closed_loop/`:

  ball_detector   <- artifacts/closed_loop/ball_detector   (WASB, trained at 960x544)
  table_detector  <- artifacts/closed_loop/table_detector  (segformerpp_b0, 960x544)
  uplifting       <- artifacts/uplifting_backview/ckpt/<run>/model (connectstage large)

each through `utils/convert.py:flax_to_torch`, with the Orbax identifier and metadata
(model, task, render_res, val_px_err; the uplifting model's architecture). `eval.closed_loop
--skip_train` and `chip_smoke.py` (phase `closed_loop`) read them;
`tests/test_torch_closed_loop.py` checks each file against the conversion of its Orbax
checkpoint. Run from the repository root (about 20 s):

    JAX_PLATFORMS=cpu python tests/make_closed_loop_weights.py
"""
import glob
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "upliftingtabletennis_torch", "weights", "closed_loop")
SOURCES = {
    "ball_detector": os.path.join(ROOT, "artifacts", "closed_loop", "ball_detector"),
    "table_detector": os.path.join(ROOT, "artifacts", "closed_loop", "table_detector"),
    "uplifting": glob.glob(os.path.join(ROOT, "artifacts", "uplifting_backview", "ckpt", "*",
                                        "model"))[0],
}


def converted(name):
    """(state dict, identifier, info) of the port checkpoint `name`, from its Orbax one."""
    import jax

    from upliftingtabletennis_tpu.utils.checkpoint import load_checkpoint
    from upliftingtabletennis_torch.utils.convert import flax_to_torch

    tree, identifier, info = load_checkpoint(SOURCES[name])
    tree = jax.device_get(tree)
    if "params" not in tree:  # the uplifting checkpoint holds its parameters alone
        tree = {"params": tree}
    return flax_to_torch(tree), identifier, info


def main():
    from upliftingtabletennis_torch.utils.checkpoint import save_checkpoint

    for name in SOURCES:
        state, identifier, info = converted(name)
        path = os.path.join(OUT, name)
        save_checkpoint(path, state, identifier, info)
        print(f"{path}: {len(state)} tensors, {os.path.getsize(path) / 2**20:.2f} MiB")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
