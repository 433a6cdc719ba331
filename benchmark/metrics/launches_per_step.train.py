"""Kernel launches per training step: the CUDA API calls that launch a kernel (profiler
count) over the traced steps."""
LAYER = "trainer (train/run_detection.py train_step)"
UNIT = "launches/step"
MOVES = "train_images_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None or not ctx["steps"] or not tr.launches:
        return None
    return tr.launches / ctx["steps"]
