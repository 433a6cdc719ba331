"""Flip-test inference: average a forward pass with one on mirrored input.

Port of `flip_back` and `flip_test_heatmaps` of
`upliftingtabletennis_tpu/ops/heatmap_decode.py`. Heatmaps and images are
NHWC, as in the JAX functions. The keypoint decoder of that module is not
ported here.
"""
from __future__ import annotations

import torch

__all__ = ["flip_back", "flip_test_heatmaps"]


def flip_back(heatmaps: torch.Tensor, flip_pairs=(), shift: bool = True) -> torch.Tensor:
    """Un-flip heatmaps (B, h, w, C) predicted on horizontally flipped inputs.

    flip_pairs: (a, b) channel pairs that swap identity under mirroring
    (empty for the single ball channel). shift: move the un-flipped maps one
    pixel right, the alignment fix of the reference's 'shift_heatmap'.
    """
    out = torch.flip(heatmaps, dims=(2,))
    if flip_pairs:
        idx = list(range(out.shape[-1]))
        for a, b in flip_pairs:
            idx[a], idx[b] = idx[b], idx[a]
        out = out[..., idx]
    if shift:
        out = torch.cat([out[:, :, :1], out[:, :, :-1]], dim=2)
    return out


def flip_test_heatmaps(apply_fn, images: torch.Tensor, flip_pairs=(),
                       shift: bool = True) -> torch.Tensor:
    """0.5 * (apply_fn(images) + flip_back(apply_fn(mirrored images))).

    apply_fn: images (B, H, W, C_in) -> heatmaps (B, h, w, C_out), both NHWC.
    """
    heat = apply_fn(images)
    heat_f = apply_fn(torch.flip(images, dims=(2,)))
    return 0.5 * (heat + flip_back(heat_f, flip_pairs, shift))
