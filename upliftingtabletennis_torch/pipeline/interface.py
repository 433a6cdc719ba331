"""Public detector API: `BallDetector`, `TableDetector` (port of
`upliftingtabletennis_tpu/pipeline/interface.py`).

Frames are processed in fixed-size chunks (the last chunk padded by
repeating its last image): resize to the model resolution (cv2 half-pixel
bilinear), ImageNet normalisation, bf16 on CUDA, the detector forward,
then subpixel peaks scaled to the 1920x1080 working resolution.

Models: SegFormer b0/b2 and ViTPose (ball and table), WASB (HRNet, ball) and
HRNet (table). The HRNet models keep f32 weights and fold their BatchNorms
once, at the first forward, into the working dtype. ViTPose is built for the
detector's resolution (its position embedding has one row per patch), the
`resolution=` override included, and runs its head's BatchNorms on their
running statistics in the working dtype.

Weights: `checkpoint` is a torch state dict (or a path to one saved with
`torch.save`), e.g. the output of `utils/convert.py:flax_to_torch`; its
tensors say which decode head, widths and input frames to build. Without a
checkpoint the model is initialised from a seeded `torch.Generator` (smoke
runs, benchmarks).

The dual-model filters are `BallDetector.filter_trajectory` and
`TableDetector.filter_trajectory` (`pipeline/filters.py`).

`BallDetector(flip_test=True)` averages each forward with a forward on the
horizontally mirrored input (`ops/heatmap_decode.py`), as the JAX detector
does; the table detector takes no flip test (mirroring swaps keypoint
identities).

Not ported yet: the slab/rolling-window paths,
`TableDetector.calibrate_camera` and the rest of the pipeline (ROADMAP queue 1,
items 4 and 5).
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.data.image_transforms import normalize_image
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.ops.heatmap_decode import flip_test_heatmaps
from upliftingtabletennis_torch.ops.peak import extract_peaks
from upliftingtabletennis_torch.ops.resize import resize_bilinear_down
from upliftingtabletennis_torch.pipeline import filters

__all__ = ["BallDetector", "TableDetector", "WIDTH", "HEIGHT", "init_weights"]

WIDTH, HEIGHT = 1920, 1080  # inference working resolution (ref: pipeline/interface.py:38)


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded random initialisation: weights N(0, 1/fan_in), biases 0, norm scales 1.
    The same weights on every device and every run."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)


def _architecture(state: Mapping[str, torch.Tensor]) -> dict:
    """The architecture options a converted state dict was made for."""
    if "model.conv1.weight" in state:  # HRNet family: only the input frames vary
        return dict(in_frames=int(state["model.conv1.weight"].shape[1]) // 3)
    if "model_backbone.patch_embed_proj.weight" in state:  # ViTPose: as the HRNets
        return dict(in_frames=int(state["model_backbone.patch_embed_proj.weight"].shape[1]) // 3)
    if "decode_head.fusion_conv.weight" in state:
        head_style, fuse = "mmseg", state["decode_head.fusion_conv.weight"]
    else:
        head_style, fuse = "nvlabs", state["decode_head.linear_fuse.weight"]
    return dict(head_style=head_style, decoder_dim=int(fuse.shape[0]),
                in_frames=int(state["backbone.patch_embed_0.weight"].shape[1]) // 3,
                classify_invisible="visible_classification.weight" in state)


class _Detector:
    """Shared chunked-inference machinery of the detectors."""

    def __init__(self, model_name: str, task: str,
                 checkpoint: Union[None, str, Mapping[str, torch.Tensor]] = None,
                 chunk: int = 16, threshold: float = -np.inf, resolution=None,
                 device="cuda", flip_test: bool = False):
        self.device = resolve_device(device)
        self.model_name, self.task, self.chunk = model_name, task, int(chunk)
        self.threshold = float(threshold)
        self.flip_test = bool(flip_test)
        # bf16 on the card (the kernels' type, as the JAX path is bf16 on the TPU)
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        state = None
        if checkpoint is not None:
            state = checkpoint
            if not isinstance(checkpoint, Mapping):
                state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        arch = _architecture(state) if state is not None else {}
        self.model, self.resolution = get_detector(model_name, task, resolution=resolution,
                                                   **arch)
        if state is None:
            init_weights(self.model)
        else:
            self.model.load_state_dict(state)
        self.model.eval().to(self.device)
        if not getattr(self.model, "FOLDS_BATCH_NORM", False):
            self.model.to(self.dtype)

    @torch.no_grad()
    def heatmaps(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C_in) in [0, 255] on self.device -> (B, C_out, h, w) f32."""
        MW, MH = self.resolution
        if tuple(images.shape[1:3]) != (MH, MW):
            x = resize_bilinear_down(images, MH, MW)
        else:
            x = images.float()
        x = normalize_image(x).to(self.dtype)
        heat = flip_test_heatmaps(self._forward, x) if self.flip_test else self._forward(x)
        return heat.permute(0, 3, 1, 2).float()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """Model input (B, H, W, C_in) -> heatmap (B, h, w, C_out), NHWC."""
        out = self.model(x)
        return out[0] if isinstance(out, tuple) else out  # TableHRNet returns the heatmap

    def _predict_frames(self, items: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
        """items: T tuples of (H, W, 3) images whose channels are concatenated
        (prev, cur, next for the ball detector) -> peaks (T, C_out, 3).

        Per chunk, each slot of the tuples is stacked on the host (a plain
        copy of whole frames) and the channels are concatenated on the device:
        interleaving 3-channel frames into 9-channel pixels on the host costs
        more than the detector itself. On CUDA the stacks go to pinned memory
        and upload asynchronously, so the host stacks the next chunk while
        the card runs this one."""
        pin = self.device.type == "cuda"
        outs = []
        for s in range(0, len(items), self.chunk):
            part = list(items[s:s + self.chunk])
            n = len(part)
            part += [part[-1]] * (self.chunk - n)  # fixed chunk shape, as the JAX path pads
            slots = []
            for k in range(len(part[0])):
                frames = [np.asarray(item[k]) for item in part]
                stack = torch.empty((self.chunk, *frames[0].shape), dtype=torch.uint8,
                                    pin_memory=pin)
                np.stack(frames, out=stack.numpy(), casting="unsafe")
                slots.append(stack.to(self.device, non_blocking=pin))
            images = torch.cat(slots, dim=-1)
            peaks = extract_peaks(self.heatmaps(images), WIDTH, HEIGHT, self.threshold)
            outs.append(peaks[:n])
        return torch.cat(outs).cpu().numpy()


class BallDetector(_Detector):
    """Ball detection on 3-frame triplets (prev, cur, next): SegFormer b0/b2, ViTPose or WASB.

    flip_test: average each forward with one on the mirrored triplets."""

    def __init__(self, model_name: str = "segformerpp_b2", checkpoint=None, chunk: int = 16,
                 resolution=None, device="cuda", flip_test: bool = False):
        super().__init__(model_name, "ball", checkpoint, chunk, threshold=-np.inf,
                         resolution=resolution, device=device, flip_test=flip_test)

    def predict(self, image_triples: Sequence):
        """image_triples: sequence of (prev, cur, next) RGB arrays (H, W, 3).

        Returns (positions (T, 3): x, y at 1920x1080 and visibility, None)."""
        return self._predict_frames([tuple(t) for t in image_triples])[:, 0], None

    @staticmethod
    def filter_trajectory(pred1, pred2, fps):
        """Frames where both models see the ball within 20 px: (positions, indices, times)."""
        return filters.filter_trajectory_ball(pred1, pred2, fps)


class TableDetector(_Detector):
    """Table keypoint detection on single frames: SegFormer b0/b2, ViTPose or HRNet
    (13 keypoints)."""

    def __init__(self, model_name: str = "segformerpp_b2", checkpoint=None, chunk: int = 16,
                 resolution=None, device="cuda"):
        super().__init__(model_name, "table", checkpoint, chunk, threshold=0.1,
                         resolution=resolution, device=device)

    def predict(self, images: Sequence):
        """images: sequence of RGB arrays (H, W, 3).

        Returns (keypoints (T, 13, 3): x, y at 1920x1080 and visibility, None)."""
        return self._predict_frames([(im,) for im in images]), None

    @staticmethod
    def filter_trajectory(pred1, pred2):
        """(T, 13, 3) x2 -> (13, 3): per keypoint, the largest DBSCAN cluster's centroid."""
        return filters.filter_trajectory_table(pred1, pred2)
