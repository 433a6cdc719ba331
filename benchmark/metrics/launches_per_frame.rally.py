"""Kernel launches per frame of the traced rallies: the CUDA API calls that launch a kernel
(profiler count), over every frame of every traced rally."""
LAYER = "pipeline (pipeline/interface.py run_rally)"
UNIT = "launches/frame"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None or not ctx["frames"] or not tr.launches:
        return None
    return tr.launches / ctx["frames"]
