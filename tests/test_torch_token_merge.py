"""ToMe token merging of the port (`ops/token_merge.py`) against the JAX module.

Same seeded numpy inputs through both, fp32. The plan (`dst`, `counts`, `n_merged`)
must be equal exactly; merge and unmerge within 1e-6. The port takes each row's
best match over blocks of rows; any blocking gives the same plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops import token_merge as jax_tm
from upliftingtabletennis_torch.ops import token_merge
from upliftingtabletennis_torch.ops.token_merge import (bipartite_soft_matching, merge_tokens,
                                                        unmerge_tokens)

torch.set_num_threads(1)


# (B, N, C, r): even N, odd N, r clipped by min(|A|, |B|), two samples
CASES = [(1, 64, 16, 16), (1, 65, 8, 20), (1, 40, 8, 100), (2, 97, 12, 30)]


def _metric(B, N, C, seed=0):
    return np.random.default_rng(seed).normal(size=(B, N, C)).astype(np.float32)


@pytest.mark.parametrize("B,N,C,r", CASES)
def test_plan_matches_jax(B, N, C, r):
    x = _metric(B, N, C)
    want = jax_tm.bipartite_soft_matching(jnp.asarray(x), r)
    got = bipartite_soft_matching(torch.from_numpy(x), r)
    assert got.n_merged == want.n_merged == N - min(r, N // 2)
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("B,N,C,r", CASES)
def test_merge_and_unmerge_match_jax(B, N, C, r):
    x = _metric(B, N, C, seed=1)
    jplan = jax_tm.bipartite_soft_matching(jnp.asarray(x), r)
    plan = bipartite_soft_matching(torch.from_numpy(x), r)
    merged = merge_tokens(plan, torch.from_numpy(x))
    jmerged = jax_tm.merge_tokens(jplan, jnp.asarray(x))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), atol=1e-6, rtol=0)
    np.testing.assert_allclose(unmerge_tokens(plan, merged).numpy(),
                               np.asarray(jax_tm.unmerge_tokens(jplan, jmerged)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("block_rows", [1, 7, 32])
def test_blocked_matching_equals_unblocked(block_rows, monkeypatch):
    x = torch.from_numpy(_metric(2, 129, 16, seed=2))
    whole = bipartite_soft_matching(x, 40)  # one block: 2 x 65 x 64 entries
    # B * |B| = 128 entries per row of the similarity matrix
    monkeypatch.setattr(token_merge, "SIM_BLOCK_ELEMENTS", block_rows * 2 * 64)
    blocked = bipartite_soft_matching(x, 40)
    assert torch.equal(whole.dst, blocked.dst) and torch.equal(whole.counts, blocked.counts)
