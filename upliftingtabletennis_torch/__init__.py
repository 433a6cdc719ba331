"""PyTorch/CUDA port of the UpliftingTableTennis system.

The JAX package `upliftingtabletennis_tpu` is the reference; this package
re-implements it module by module in PyTorch, with every Pallas kernel on
the ported path replaced by a hand-written CUDA kernel for Hopper (sm_90a).
It imports torch, numpy, scipy and the standard library at runtime; a few entry points
import more inside themselves, as the JAX package does: OpenCV to decode video
(`data/video.py`, `extract_ttst.extract_images`), PyYAML for BlurBall's calibrations, and
TensorBoard for the trainers' runs where it is installed.

It covers all of the JAX package: the detectors and their filters, the pose ops, the
pipeline (`hub.full_pipeline`, with `weights_url` for the reference's weights zip), the
physics, fitting and synthetic data, the trainers (detectors, BlurBall pretraining
included; uplifting, over several processes under torchrun), the evaluations, the dataset
readers and extractors, and the figures. Entry points run on CUDA by default and raise
when CUDA is absent; pass ``device="cpu"`` for the plain PyTorch path the tests use.
"""
from upliftingtabletennis_torch._device import resolve_device

__all__ = ["resolve_device"]
