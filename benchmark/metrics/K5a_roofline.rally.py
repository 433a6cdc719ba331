"""K5a's share of its roofline in the traced rallies: the least time of the HRNets' stride-1
3x3 convolutions (the frozen `k5_bound` over the shapes of the published graph, every
forward the rallies ran, at the chunk's batch) over the device time of `conv3x3_kernel`."""
from benchmark.counts import work

LAYER = "kernels (ops/, ops/csrc/)"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None:
        return None
    spent = tr.kernel_seconds(lambda n: "conv3x3_kernel" in n)
    if spent <= 0:
        return None
    cfg, chunk = ctx["config"], ctx["chunk"]
    hr_ball, hr_table = work.roles(cfg, "hrnet")
    least = ctx["pieces"] * sum(work.k5a_seconds(cfg, r, chunk) for r in hr_ball) \
        + ctx["table_pieces"] * sum(work.k5a_seconds(cfg, r, chunk) for r in hr_table)
    return 100.0 * least / spent
