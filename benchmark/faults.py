"""Faults planted in the program at run time (nothing is edited), to show that a cell's
check fails them: used by the CPU tests and, at a cell's own size on the card, by
`control.py --fault`. Each is a context manager that patches the port and restores it."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def shifted_peaks():
    """A rally's answer altered where it is produced: every peak 300 px to the right."""
    from upliftingtabletennis_torch.pipeline import interface

    real = interface.extract_peaks

    def moved(*a, **k):
        out = real(*a, **k).clone()
        out[..., 0] += 300.0
        return out
    return patched(interface, "extract_peaks", moved)


def half_pieces():
    """Half of each rally piece left out: its second half repeats the first half's peaks."""
    from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

    real = TableTennisPipeline._slab_step

    def halved(self, window, idx3, table_idx):
        outs = real(self, window, idx3, table_idx)
        h = outs[0].shape[0] // 2
        return [torch.cat([o[:h], o[:o.shape[0] - h]]) for o in outs]
    return patched(TableTennisPipeline, "_slab_step", halved)


def unchanged_state():
    """A training step that returns its state unchanged: no update."""
    from upliftingtabletennis_torch.train import run_detection as RD

    return patched(RD, "apply_update", lambda *a, **k: None)


def half_batch(drop=None):
    """Half of the training batch left out, the mean taken over the rest: the rows `drop`,
    by default the second half."""
    from upliftingtabletennis_torch.train import run_detection as RD

    real = RD.loss_fn

    def halved(model, imgs, target, drop_masks=None):
        gone = range(imgs.shape[0] // 2, imgs.shape[0]) if drop is None else drop
        keep = [i for i in range(imgs.shape[0]) if i not in gone]
        return real(model, imgs[keep], target[keep], drop_masks)
    return patched(RD, "loss_fn", halved)


def altered_loss():
    """A training step's answer altered where it is produced: the loss half as large again."""
    from upliftingtabletennis_torch.train import run_detection as RD

    real = RD.M.weighted_mse_loss
    return patched(RD.M, "weighted_mse_loss", lambda p, t: 1.5 * real(p, t))


RALLY = {"shifted_peaks": shifted_peaks, "half_pieces": half_pieces}
TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_loss": altered_loss}
