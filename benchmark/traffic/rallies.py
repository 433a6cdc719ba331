"""The order of a rally cell's work, from the seed: groups of rallies whose lengths are the
mix's fixed groups (every group holds the same number of frames, so a window that ends
at a group's end has done the same work per rally whatever the order), each cycle a fresh
shuffle of the groups and of the rallies within each; each rally a contiguous slice of the
frame pool at an offset drawn from the seed."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def schedule(seed: int, groups, pool_frames: int, n: int) -> List[List[Tuple[int, int]]]:
    """`n` groups, each a list of rallies (offset, length) into the pool."""
    rng = np.random.default_rng([seed, 2])
    groups = [[int(T) for T in g] for g in groups]
    longest = max(max(g) for g in groups)
    if longest > pool_frames:
        raise ValueError(f"a rally of {longest} frames does not fit the pool's {pool_frames}")
    out: List[List[Tuple[int, int]]] = []
    while len(out) < n:
        for gi in rng.permutation(len(groups)):
            out.append([(int(rng.integers(0, pool_frames - T + 1)), int(T))
                        for T in rng.permutation(groups[gi])])
    return out[:n]
