"""The training step's useful work against the chip's bf16 peak: three times the forward's
operations per image (forward, and the backward's two products per forward product),
counted from the published shapes (`counts/models.py`), times the images of the traced
steps, over the traced window and 989 TFLOP/s, in percent."""
from benchmark.counts import models
from benchmark.counts.peaks import BF16_TC_FLOPS

LAYER = "models (models/segformer.py, models/hrnet.py)"
UNIT = "%"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None or tr.window_s <= 0 or not ctx["images"]:
        return None
    m = ctx["config"]["model"]
    W, H = m["input_wh"]
    seg = ctx["config"]["segformer"][m["size"]]
    per_image = 3 * models.segformer_flops(seg, W, H, m["in_frames"], m["out_channels"])
    return 100.0 * per_image * ctx["images"] / tr.window_s / BF16_TC_FLOPS
