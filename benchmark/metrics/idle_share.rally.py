"""The share of the traced window in which no operation ran on the device: 1 - (the union
of the device operations' intervals) / (the window), in percent."""
LAYER = "device (one H100)"
UNIT = "%"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx and ctx["trace"]
    if tr is None or tr.window_s <= 0 or not len(tr.names):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
