"""ToMe token merging (bipartite soft matching) for the SegFormer++ backbone.

Port of `upliftingtabletennis_tpu/ops/token_merge.py`. Tokens split
alternately into sets A (even) and B (odd); each A token finds its most
cosine-similar B token; the r A tokens with the highest similarity merge
(mean) into their B partners, so N tokens become N - r; `unmerge_tokens`
gathers the merged features back to every source position.

Two deliberate differences from the JAX function, neither of which changes
a plan:

- The (B, |A|, |B|) similarity matrix is never built whole. Each row's max
  and argmax are taken over blocks of rows, one `torch.matmul` per block
  (`SIM_BLOCK_ELEMENTS` entries at a time): at SegFormer-b2 stage 1 at
  1600x896 the whole matrix would be 2.0e9 entries per frame. A row's max
  and first argmax do not depend on the blocking. The products run in the
  input's dtype, as the JAX einsum does.
- The plan's types: `dst` is int64 (torch's index type) and `counts` f32,
  where the JAX plan holds int32 and the metric's dtype. `merge_tokens`
  sums in f32 and rounds the mean to the input's dtype once (the JAX
  function sums in the input's dtype; the two agree exactly in f32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TokenMerge", "bipartite_soft_matching", "merge_tokens", "unmerge_tokens"]

# entries of one block of the similarity matrix (2^28: 512 MB in bf16)
SIM_BLOCK_ELEMENTS = 1 << 28


class TokenMerge(NamedTuple):
    dst: torch.Tensor     # (B, N) int64: destination slot of each source token
    counts: torch.Tensor  # (B, nm) f32: sources per destination slot
    n_merged: int         # nm = N - r


def _best_match(a, b, block_rows: int):
    """Per row of a (B, na, C): max of a . bᵀ over b's rows and its first argmax."""
    bt = b.transpose(1, 2)
    vals, idxs = [], []
    for i in range(0, a.shape[1], block_rows):
        val, idx = torch.matmul(a[:, i:i + block_rows], bt).max(dim=-1)
        vals.append(val)
        idxs.append(idx)
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def bipartite_soft_matching(metric: torch.Tensor, r: int) -> TokenMerge:
    """The ToMe merge plan for tokens with features `metric` (B, N, C).

    r: tokens to remove, clipped to min(|A|, |B|).
    """
    B, N, _ = metric.shape
    na = (N + 1) // 2  # even indices: set A
    nb = N - na        # odd indices: set B
    r = int(min(r, nb, na))
    nm = N - r
    dev = metric.device

    m = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-6)
    block_rows = max(1, SIM_BLOCK_ELEMENTS // max(1, B * nb))
    best_val, best_idx = _best_match(m[:, 0::2], m[:, 1::2], block_rows)

    # the r most similar A tokens merge into their B partners (stable sort, as jnp.argsort)
    order = torch.argsort(-best_val, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    merged = rank < r

    # merged layout: [unmerged A (compacted order)..., all B tokens...]
    unmerged_before = torch.cumsum(~merged, dim=-1) - 1
    a_dst = torch.where(merged, (na - r) + best_idx, unmerged_before)
    b_dst = (na - r) + torch.arange(nb, device=dev)

    dst = torch.empty(B, N, dtype=torch.int64, device=dev)
    dst[:, 0::2] = a_dst
    dst[:, 1::2] = b_dst
    counts = torch.zeros(B, nm, dtype=torch.float32, device=dev)
    counts.scatter_add_(1, dst, torch.ones(B, N, dtype=torch.float32, device=dev))
    return TokenMerge(dst, counts, nm)


def _flat_dst(plan: TokenMerge) -> torch.Tensor:
    """dst as rows of the (B * nm, C) merged tensor, (B * N,)."""
    B = plan.dst.shape[0]
    offs = torch.arange(B, device=plan.dst.device)[:, None] * plan.n_merged
    return (plan.dst + offs).reshape(-1)


def merge_tokens(plan: TokenMerge, x: torch.Tensor) -> torch.Tensor:
    """Mean-merge (B, N, C) -> (B, nm, C) with a scatter-add (summed in f32)."""
    B, N, C = x.shape
    out = torch.zeros(B * plan.n_merged, C, dtype=torch.float32, device=x.device)
    out.index_add_(0, _flat_dst(plan), x.reshape(B * N, C).float())
    return (out.view(B, plan.n_merged, C) / plan.counts[..., None]).to(x.dtype)


def unmerge_tokens(plan: TokenMerge, merged: torch.Tensor) -> torch.Tensor:
    """Gather merged features back to the source positions: (B, nm, C) -> (B, N, C)."""
    B, nm, C = merged.shape
    return merged.reshape(B * nm, C).index_select(0, _flat_dst(plan)).view(B, -1, C)
