"""Validation summaries of the uplifting trainer, numpy.

Port of `count_missortings` from `upliftingtabletennis_tpu/utils/visualization.py`
(`:105`). The figures of that module (the confusion matrix, the ROC curve and the heatmap
overlays, rendered for TensorBoard) are not ported yet: ROADMAP queue 1, item 7.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["count_missortings"]


def count_missortings(labels: np.ndarray, scores: np.ndarray) -> Tuple[int, float]:
    """The fewest misclassifications over all thresholds (predict positive at score >=
    threshold) and the optimal threshold, the one closest to 0 among ties."""
    labels = np.asarray(labels).astype(int)
    scores = np.asarray(scores, np.float64)
    thresholds = np.sort(np.unique(scores))[::-1]
    preds = scores[None, :] >= thresholds[:, None]  # (thresholds, N)
    miss = np.sum(preds != labels[None, :].astype(bool), axis=1)
    best = miss.min()
    cand = thresholds[miss == best]
    return int(best), float(cand[np.argmin(np.abs(cand))])
