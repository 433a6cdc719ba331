"""K1's share of its roofline in the traced training steps: the least time of the forward's
attention half-blocks (the frozen `k1_bound` over every MiT block, at the step's batch)
over the device time of K1's forward kernels (`Trace.k1_seconds`, as in
`K1_roofline.rally`; K1's recompute backward is plain PyTorch and is not K1's time)."""
from benchmark.counts import work

LAYER = "kernels (ops/, ops/csrc/)"
UNIT = "%"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None:
        return None
    spent = tr.k1_seconds()
    if spent <= 0:
        return None
    return 100.0 * ctx["steps"] * work.k1_seconds(ctx["config"], None, ctx["batch"]) / spent
