"""K4b's share of its roofline in the traced training steps: the least time of the
depthwise convs' backward (the frozen `k4_bwd_bound` over every MiT block, at the step's
batch) over the device time of `dw_bwd_kernel` and `dw_sum_kernel`."""
from benchmark.counts import work

LAYER = "kernels (ops/, ops/csrc/)"
UNIT = "%"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None:
        return None
    spent = tr.kernel_seconds(lambda n: "dw_bwd_kernel" in n or "dw_sum_kernel" in n)
    if spent <= 0:
        return None
    return 100.0 * ctx["steps"] * work.k4_bwd_seconds(ctx["config"], ctx["batch"]) / spent
