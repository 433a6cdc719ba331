"""Write the EMA weights of a resumable `latest` training state as a `model` checkpoint.

Port of the root `tools/extract_model_from_latest.py`. The uplifting trainer
(`train/run_uplifting.py`) saves its four best-model checkpoints only when a validation
metric improves; a fine-tune resumed with the previous run's best metrics may never save
one, even when its own target improved. This tool turns any `latest` snapshot into a
checkpoint that `hub.uplifting(checkpoint=...)` and `load_model_from_checkpoint` load:

    python -m upliftingtabletennis_torch.tools.extract_model_from_latest \\
        --latest <run_dir>/latest --out <run_dir>/model_backview

The model is rebuilt on the CPU from the snapshot's hyperparameters; its metadata keeps
them (without the best metrics) and adds "from_latest": true.
"""
from __future__ import annotations

import argparse

__all__ = ["extract", "main"]


def extract(latest: str, out: str) -> dict:
    """Write the EMA state dict of the `latest` snapshot at `out`; returns its info."""
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
    from upliftingtabletennis_torch.train.run_uplifting import ema_state_dict, load_state
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    sd, identifier, info = load_checkpoint(latest)
    model = get_uplifting_model(info.get("name", "connectstage"), info.get("size", "large"),
                                info.get("tabletoken_mode", "dynamic"),
                                info.get("time_rotation", "new"))
    state = load_state(model, sd)
    extra = {k: v for k, v in info.items() if k != "best"}
    extra["from_latest"] = True
    save_checkpoint(out, ema_state_dict(model, state), identifier, extra)
    return extra


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--latest", required=True, help="<run_dir>/latest of run_uplifting")
    p.add_argument("--out", required=True, help="the model checkpoint to write")
    args = p.parse_args(argv)
    info = extract(args.latest, args.out)
    print(f"saved EMA params of epoch {info.get('epoch')} -> {args.out}")
    return info


if __name__ == "__main__":
    main()
