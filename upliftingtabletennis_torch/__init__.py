"""PyTorch/CUDA port of the UpliftingTableTennis system.

The JAX package `upliftingtabletennis_tpu` is the reference; this package
re-implements it module by module in PyTorch, with every Pallas kernel on
the ported path replaced by a hand-written CUDA kernel for Hopper (sm_90a).
It imports only torch, numpy, scipy and the standard library at runtime.

Covered today: the detectors and their filters: `BallDetector` (SegFormer
b0/b2, ViTPose, WASB-HRNet; `hub.ball_detection`), `TableDetector` (SegFormer
b0/b2, ViTPose, HRNet; `hub.table_detection`) and their `filter_trajectory`
methods; the pose ops (`ops.nms`, `ops.heatmap_decode`, `ops.ae_grouping`); and the
SegFormer detector trainer (`train.run_detection`). Entry points run on CUDA by default and raise
when CUDA is absent; pass ``device="cpu"`` for the plain PyTorch path the
tests use.
"""
from upliftingtabletennis_torch._device import resolve_device

__all__ = ["resolve_device"]
