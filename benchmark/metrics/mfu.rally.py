"""The detectors' useful work over the traced window against the chip's bf16 peak: each
frame's ball pair (SegFormer-b2 on its triplet, WASB) and, on the frames the table stride
asks for, the table pair, counted from the published shapes (`counts/models.py`), over the
window's length and 989 TFLOP/s, in percent."""
from benchmark.counts import models
from benchmark.counts.peaks import BF16_TC_FLOPS

LAYER = "models (models/segformer.py, models/hrnet.py)"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None or tr.window_s <= 0 or not ctx["frames"]:
        return None
    cfg = ctx["config"]
    ball = sum(models.detector_flops(cfg, r) for r in cfg["detectors"] if r.startswith("ball"))
    table = sum(models.detector_flops(cfg, r) for r in cfg["detectors"] if r.startswith("table"))
    work = ball * ctx["frames"] + table * ctx["table_frames"]
    return 100.0 * work / tr.window_s / BF16_TC_FLOPS
