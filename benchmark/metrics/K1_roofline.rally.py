"""K1's share of its roofline in the traced rallies: the least time of the attention
half-blocks' work (the frozen `k1_bound` over every MiT block of every SegFormer forward the
rallies ran, at the chunk's batch) over the device time of K1's kernels (`Trace.k1_seconds`:
each `uttk::k1::attn_kernel` with the LayerNorm before it and the out-projection after it)."""
from benchmark.counts import work

LAYER = "kernels (ops/, ops/csrc/)"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None:
        return None
    spent = tr.k1_seconds()
    if spent <= 0:
        return None
    cfg, chunk = ctx["config"], ctx["chunk"]
    seg_ball, seg_table = work.roles(cfg, "segformer")
    least = ctx["pieces"] * sum(work.k1_seconds(cfg, r, chunk) for r in seg_ball) \
        + ctx["table_pieces"] * sum(work.k1_seconds(cfg, r, chunk) for r in seg_table)
    return 100.0 * least / spent
