"""The least device time of the work each kernel family does in one detector forward, from
the published shapes (`counts/models.py`) and the frozen bounds (`counts/bounds.py`)."""
from __future__ import annotations

from typing import Optional

from benchmark.counts import bounds, models


def segformer_input(config, role: Optional[str]):
    """(MiT widths, input W, input H) of a SegFormer: the detector `role` of an ensemble's
    configuration, or with `role` None the one model of a training configuration."""
    m = config["model"] if role is None else config["detectors"][role]
    W, H = m["input_wh"]
    return config["segformer"][m["size"]], W, H


def k1_seconds(config, role: Optional[str], B: int) -> float:
    """K1's bound summed over the attention half-blocks of one SegFormer forward of batch B
    (`role` as `segformer_input` takes it)."""
    seg, W, H = segformer_input(config, role)
    return sum(st["depth"] * bounds.k1_bound(B, st["N"], st["C"], st["heads"], st["Nkv"])[0]
               for st in models.mit_stages(seg, W, H))


def k5a_seconds(config, role: str, B: int) -> float:
    """K5a's bound summed over the stride-1 3x3 convolutions of one HRNet forward of batch B."""
    det = config["detectors"][role]
    W, H = det["input_wh"]
    return sum(bounds.k5_bound(3, B, c["H"], c["W"], c["Ci"], c["Co"], c["residual"])[0]
               for c in models.hrnet_convs(config["hrnet"], W, H, det["in_frames"],
                                           det["out_channels"])
               if c["ks"] == 3 and c["stride"] == 1)


def roles(config, arch: str):
    """(ball role, table role) of the configuration's detectors of one architecture."""
    found = [r for r, d in config["detectors"].items() if d["arch"] == arch]
    return ([r for r in found if r.startswith("ball")], [r for r in found if r.startswith("table")])


def k4_bwd_seconds(config, B: int) -> float:
    """K4's backward bound summed over the MixFFN depthwise convs of one training step of
    batch B (one call per MiT block, on the hidden tensor)."""
    seg, W, H = segformer_input(config, None)
    return sum(st["depth"] * bounds.k4_bwd_bound(B, st["H"], st["W"], seg["mlp_ratio"] * st["C"])[0]
               for st in models.mit_stages(seg, W, H))
