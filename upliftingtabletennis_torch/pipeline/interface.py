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

`UpliftingModel` lifts the filtered 2D track to 3D positions and spin
(`models/uplifting.py`, f32). `TableTennisPipeline.run_rally` is the main path: the
rally is uploaded in exact-chunk pieces (pinned, asynchronous, 3 pieces ahead),
converted from i420 on the card when given so, and the four detectors run on a
rolling (prev, cur, next) window of pieces with host-computed local indices, so no
frame is uploaded twice; the peaks are fetched once at the end of the rally, then
filtered, and the uplifting model runs when at least 2 ball detections survive.
`calibrate_camera` fits the camera to the fused table keypoints
(`core/calibration.py`).

`TableTennisPipeline.fit_physics` recovers (r0, v0, w0) of one flight segment from its
filtered 2D track by differentiable-physics fitting (`core/fitting.py`, the S1
integrator kernel), optionally seeded with the uplifting model's output.

Not ported: `UpliftingModel.from_reference_checkpoint` (no reference `.pt` in the
repo) and the `mesh` argument (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.core import geometry as G
from upliftingtabletennis_torch.core.calibration import calibrate_camera as _calibrate
from upliftingtabletennis_torch.core.fitting import fit_trajectory
from upliftingtabletennis_torch.core.physics import BallState
from upliftingtabletennis_torch.data.image_transforms import (host_downscale, i420_to_rgb,
                                                              normalize_image)
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.ops.heatmap_decode import flip_test_heatmaps
from upliftingtabletennis_torch.ops.peak import extract_peaks
from upliftingtabletennis_torch.ops.resize import resize_bilinear_down
from upliftingtabletennis_torch.pipeline import filters
from upliftingtabletennis_torch.utils.checkpoint import load_model_from_checkpoint

__all__ = ["BallDetector", "TableDetector", "UpliftingModel", "TableTennisPipeline", "WIDTH",
           "HEIGHT", "init_weights"]

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

    def peaks_on_device(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C_in) in [0, 255] on self.device -> peaks (B, C_out, 3) on the
        device: x, y at 1920x1080 and visibility. The one device step of both `predict`
        and `TableTennisPipeline.run_rally`."""
        return extract_peaks(self.heatmaps(images), WIDTH, HEIGHT, self.threshold)

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
            outs.append(self.peaks_on_device(torch.cat(slots, dim=-1))[:n])
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

    @staticmethod
    def calibrate_camera(keypoints, resolution=None, device="cuda"):
        """Fused keypoints (13, 3) -> (Mint (3, 3), Mext (4, 4), inlier count), by RANSAC
        and LM on `device` (f32) with the default seeded draws.

        `resolution` is the (W, H) of the frame the keypoints live in: the camera's
        principal point is pinned at its centre. Defaults to 1920x1080, the detectors'
        working resolution."""
        res = tuple(int(v) for v in resolution) if resolution else (WIDTH, HEIGHT)
        kp = torch.as_tensor(np.asarray(keypoints), dtype=torch.float32,
                             device=resolve_device(device))
        Mint, Mext, n = _calibrate(kp[:, :2], kp[:, 2], res, use_ransac=True)
        return Mint.cpu().numpy(), Mext.cpu().numpy(), int(n)

    KEYPOINT_VISIBLE = 1


class UpliftingModel:
    """2D -> 3D uplifting: filtered ball detections, fused table keypoints and times ->
    (spin in the flight frame (3,), 3D positions (T', 3)).

    checkpoint: a port checkpoint path (`utils/checkpoint.py`, its `.json` names the
    architecture and `transform_mode`), a state dict for the architecture the other
    arguments name, or None for seeded random weights. f32 on `device`."""

    def __init__(self, checkpoint: Union[None, str, Mapping[str, torch.Tensor]] = None,
                 name: str = "connectstage", size: str = "large", mode: str = "dynamic",
                 time_rotation: str = "new", transform_mode: str = "global", device="cuda"):
        self.device = resolve_device(device)
        self.transform_mode = transform_mode
        if checkpoint is None or isinstance(checkpoint, Mapping):
            self.model = get_uplifting_model(name, size, mode, time_rotation)
            if checkpoint is None:
                init_weights(self.model)
            else:
                self.model.load_state_dict(checkpoint)
        else:
            self.model, _, _, info = load_model_from_checkpoint(checkpoint)
            self.transform_mode = info.get("transform_mode", transform_mode)
        self.model.eval().to(self.device)

    @torch.no_grad()
    def predict_without_normalization(self, ball, table, mask, times):
        """Normalised, padded inputs (`filters.uplifting_inputs`): ball (1, L, 2), table
        (1, 13, 3), mask (1, L), times (1, L) -> (spin (3,), positions (T', 3)), T' the
        valid steps. With transform_mode 'global' the spin is turned into the flight
        frame in the same call."""
        n = int(np.asarray(mask).sum())
        rot, pos = self.model(*(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                                device=self.device)
                                for a in (ball, table, mask, times)))
        if self.transform_mode == "global":
            rot = G.transform_rotation_axes(rot, pos)
        return rot.cpu().numpy()[0], pos.cpu().numpy()[0, :n]

    def predict(self, ball_coords, table_coords, times):
        """Pixel inputs at 1920x1080: ball (T', 2), table (13, 3), times (T',)."""
        ball, table, t, mask = filters.uplifting_inputs(ball_coords, table_coords, times,
                                                        WIDTH, HEIGHT)
        return self.predict_without_normalization(ball, table, mask, t)


class TableTennisPipeline:
    """Monocular rally video -> 3D trajectory and spin, with the fixed ensemble: ball
    SegFormer-b2 (main) and WASB (aux), table SegFormer-b2 (main) and HRNet (aux), then
    the uplifting model.

    checkpoints: {"ball_main", "ball_aux", "table_main", "table_aux", "uplifting"} ->
    port checkpoints; a missing entry gets seeded random weights."""

    LOOKAHEAD = 3  # pieces uploaded ahead of the one the detectors run on

    def __init__(self, checkpoints: Optional[dict] = None, chunk: int = 8, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError("multi-card inference (`mesh`) is not ported: ROADMAP "
                                      "queue 1, item 5")
        ck = checkpoints or {}
        self.ball_detector = BallDetector("segformerpp_b2", ck.get("ball_main"), chunk,
                                          device=device)
        self.ball_detector_aux = BallDetector("wasb", ck.get("ball_aux"), chunk, device=device)
        self.table_detector = TableDetector("segformerpp_b2", ck.get("table_main"), chunk,
                                            device=device)
        self.table_detector_aux = TableDetector("hrnet", ck.get("table_aux"), chunk,
                                                device=device)
        self.uplifting_model = UpliftingModel(ck.get("uplifting"), device=device)
        self.KEYPOINT_VISIBLE = 1

    @property
    def device(self) -> torch.device:
        return self.ball_detector.device

    def _detectors(self):
        return (self.ball_detector, self.ball_detector_aux, self.table_detector,
                self.table_detector_aux)

    def _slab_step(self, window: torch.Tensor, idx3: torch.Tensor,
                   table_idx: Optional[torch.Tensor]):
        """The device step of one piece: window (3 * chunk, H, W, 3) uint8 RGB, the
        (prev, cur, next) pieces; idx3 (3, chunk) local triplet indices; table_idx
        (chunk,) local table frames, None for a ball-only piece. -> peaks (chunk, C, 3) of
        each detector (ball main, ball aux[, table main, table aux]), on the device."""
        triplets = torch.cat([window[idx3[0]], window[idx3[1]], window[idx3[2]]], dim=-1)
        outs = self._pair(self.ball_detector, self.ball_detector_aux, triplets)
        if table_idx is not None:
            outs += self._pair(self.table_detector, self.table_detector_aux, window[table_idx])
        return outs

    @staticmethod
    def _pair(main, aux, images):
        """Both detectors' peaks; one forward when main and aux are one detector (the
        closed loop's pipeline)."""
        peaks = main.peaks_on_device(images)
        return [peaks, peaks if aux is main else aux.peaks_on_device(images)]

    def _rally_peaks(self, images, table_stride: int = 1, pixel_format: str = "rgb",
                     upload_res="model"):
        """Every detector's peaks over the rally: (ball_main (T, 3), ball_aux (T, 3),
        table_main (T_t, 13, 3), table_aux (T_t, 13, 3)), T_t the frames
        0, table_stride, ...; the frame record `_last_frame_res` is set."""
        if isinstance(images, np.ndarray) and images.dtype == np.uint8:
            frames = images
        else:
            frames = np.stack([np.asarray(im) for im in images])
            if frames.dtype != np.uint8:
                frames = frames.astype(np.uint8)
        if pixel_format not in ("rgb", "i420"):
            raise ValueError(f"unknown pixel_format {pixel_format!r}")
        i420 = pixel_format == "i420"
        # detections are returned in the caller's frame: calibrate_camera pins its
        # principal point at this frame's centre
        src_h = frames.shape[1] * 2 // 3 if i420 else frames.shape[1]
        src_w = frames.shape[2]
        self._last_frame_res = (int(src_w), int(src_h))
        if upload_res == "model":
            upload_res = (max(d.resolution[0] for d in self._detectors()),
                          max(d.resolution[1] for d in self._detectors()))
        target, (h, w) = None, (src_h, src_w)
        if upload_res is not None and src_w > int(upload_res[0]) and src_h > int(upload_res[1]):
            target = (int(upload_res[0]), int(upload_res[1]))
            w, h = target
        device = self.device
        pin = device.type == "cuda"
        T = frames.shape[0]
        chunk = self.ball_detector.chunk
        n_pieces = (T + chunk - 1) // chunk
        Tpad = n_pieces * chunk

        def stage(k):
            """Piece k on the host, pinned: downscaled when asked, padded to the chunk by
            repeating its last frame. Runs on a worker thread, so that the downscale
            overlaps the launches of the pieces before (torch's resize and numpy's copy
            release the GIL)."""
            part = frames[k * chunk:(k + 1) * chunk]
            if target is not None:
                part = host_downscale(part, target, pixel_format)
            stack = torch.empty((chunk, *part.shape[1:]), dtype=torch.uint8, pin_memory=pin)
            host = stack.numpy()
            host[:len(part)] = part
            host[len(part):] = part[-1]
            return stack

        def upload(stack):
            """A staged piece on the device as RGB (chunk, h, w, 3) uint8, copied without
            blocking the host."""
            dev = stack.to(device, non_blocking=pin)
            return i420_to_rgb(dev, h, w) if i420 else dev

        def local3(g, k):
            """(Padded) global frame indices -> indices into the (prev, cur, next) window."""
            return ((g // chunk) - k + 1) * chunk + g % chunk

        # the index arrays repeat for every interior piece and every rally: each distinct
        # one is copied to the device once per pipeline (a copy from pageable memory waits
        # for the card's queue)
        cache = self.__dict__.setdefault("_idx_cache", {})

        def dev_const(arr):
            arr = np.ascontiguousarray(arr, np.int64)
            key = (arr.shape, arr.tobytes())
            if key not in cache:
                cache[key] = torch.from_numpy(arr).to(device)
            return cache[key]

        table_centers = np.arange(0, T, table_stride)
        ball_outs, table_outs = [], []
        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = []  # host pieces, staged up to LOOKAHEAD pieces beyond the uploads
            pieces = []  # device pieces, uploaded up to LOOKAHEAD pieces ahead
            for k in range(n_pieces):
                while len(pieces) < min(k + 1 + self.LOOKAHEAD, n_pieces):
                    while len(staged) < min(len(pieces) + 1 + self.LOOKAHEAD, n_pieces):
                        staged.append(pool.submit(stage, len(staged)))
                    pieces.append(upload(staged[len(pieces)].result()))
                    staged[len(pieces) - 1] = None
                c0 = k * chunk
                centers = np.arange(c0, c0 + chunk)
                idx3 = dev_const(np.stack([local3(np.maximum(centers - 1, 0), k),
                                           local3(centers, k),
                                           local3(np.minimum(centers + 1, Tpad - 1), k)]))
                window = torch.cat([pieces[k - 1] if k > 0 else pieces[0], pieces[k],
                                    pieces[k + 1] if k + 1 < n_pieces else pieces[k]])
                in_slab = table_centers[(table_centers >= c0) & (table_centers < c0 + chunk)]
                tloc = None
                if len(in_slab):
                    tloc = np.full(chunk, chunk + in_slab[-1] - c0)
                    tloc[:len(in_slab)] = chunk + in_slab - c0
                    tloc = dev_const(tloc)
                outs = self._slab_step(window, idx3, tloc)
                ball_outs.append(outs[:2])
                if tloc is not None:
                    table_outs.append((*outs[2:], len(in_slab)))
                if k >= 2:  # piece k-2 is out of every later window: free it
                    pieces[k - 2] = None

        # one device-to-host copy per detector, at the end of the rally
        ball_main = torch.cat([o[0] for o in ball_outs]).cpu().numpy()[:T, 0]
        ball_aux = torch.cat([o[1] for o in ball_outs]).cpu().numpy()[:T, 0]
        tm = torch.cat([o[0] for o in table_outs]).cpu().numpy()
        ta = torch.cat([o[1] for o in table_outs]).cpu().numpy()
        keep = np.concatenate([np.arange(i * chunk, i * chunk + n)
                               for i, (_, _, n) in enumerate(table_outs)])
        return ball_main, ball_aux, tm[keep], ta[keep]

    def run_rally(self, images, fps: float, table_stride: int = 1, pixel_format: str = "rgb",
                  upload_res="model"):
        """The whole rally with every intermediate.

        images: a list of RGB frames or one (T, H, W, 3) uint8 array; with pixel_format
        "i420", planar YUV 4:2:0 frames (T, H * 3 // 2, W), converted to RGB on the card.
        fps: the video's frame rate. table_stride: run the table detectors on every
        stride-th frame only (the table filter fuses keypoints over frames anyway).
        upload_res: "model" downscales frames on the host to the largest detector input
        before upload when the frame is larger on both axes; a (W, H) tuple picks that
        size; None uploads frames as given.

        Returns {"ball" (T', 2) filtered detections at 1920x1080, "valid_idx" (T',)
        indices into the interior frames 1..T-2, "times" (T',) seconds, "table" (13, 3)
        fused keypoints, "spin" (3,) or None, "pos3d" (T'', 3) or None}."""
        ball_main, ball_aux, table_main, table_aux = self._rally_peaks(
            images, table_stride, pixel_format, upload_res)
        T = len(ball_main)
        # interior frames only: the reference builds triplets for frames 1..T-2
        ball, valid_idx, times = filters.filter_trajectory_ball(ball_main[1:T - 1],
                                                                ball_aux[1:T - 1], fps)
        table = filters.filter_trajectory_table(table_main, table_aux)
        spin = pos3d = None
        if len(ball) >= 2:
            b, t, tt, mask = filters.uplifting_inputs(ball, table, times, WIDTH, HEIGHT)
            spin, pos3d = self.uplifting_model.predict_without_normalization(b, t, mask, tt)
        return {"ball": ball, "valid_idx": valid_idx, "times": times, "table": table,
                "spin": spin, "pos3d": pos3d}

    def predict(self, images, fps: float, table_stride: int = 1, pixel_format: str = "rgb",
                upload_res="model"):
        """One rally -> (spin in the flight frame (3,), 3D positions (T', 3)), or Nones
        when fewer than 2 ball detections survive the filter."""
        out = self.run_rally(images, fps, table_stride, pixel_format, upload_res)
        return out["spin"], out["pos3d"]

    def calibrate_camera(self, keypoints, resolution=None):
        """Camera from the fused table keypoints (13, 3), on the pipeline's device.
        `resolution` defaults to the frame of the last `run_rally` / `predict` call, the
        frame the detections live in."""
        if resolution is None:
            resolution = getattr(self, "_last_frame_res", None)
        return TableDetector.calibrate_camera(keypoints, resolution, self.device)

    @staticmethod
    def physics_seed(init, times) -> Optional[BallState]:
        """The fit's seed from `predict`'s output init = (spin_local (3,), pos3d (T', 3)):
        r0 the first position, v0 from the first two positions and times, w0 the spin
        in the world frame (float32 CPU tensors); None without at least 2 positions."""
        spin_local, pos3d = init
        if pos3d is None or len(pos3d) < 2:
            return None
        times = np.asarray(times, np.float32)
        v0 = (np.asarray(pos3d[1]) - np.asarray(pos3d[0])) / max(float(times[1] - times[0]),
                                                                 1e-3)
        pos = torch.as_tensor(np.asarray(pos3d), dtype=torch.float32)
        w_world = G.inverse_transform_rotation_axes(
            torch.as_tensor(np.asarray(spin_local), dtype=torch.float32), pos)
        return BallState(r=pos[0], v=torch.as_tensor(v0, dtype=torch.float32), w=w_world)

    def fit_physics(self, ball, times, Mint, Mext, *, init=None, **fit_kw):
        """Recover (r0, v0, w0) of ONE ball-flight segment by differentiable-physics
        fitting of its filtered 2D detections (`core/fitting.py:fit_trajectory`), on the
        pipeline's device unless `device=` is given.

        ball (T', 2) filtered detections in the 1920x1080 frame (the `run_rally` output);
        times (T',) seconds; (Mint, Mext) from `calibrate_camera`. `init=(spin_local,
        pos3d)` seeds the fit with `predict`'s output (the hybrid mode: the seed joins the
        full multi-start and breaks loss ties; keep `n_starts` at its default). The
        horizon is rounded up to a 0.25 s bucket. Returns (spin_local (3,), positions_3d
        (T', 3), FitResult); gate downstream use on `FitResult.reproj_px`."""
        ball = np.asarray(ball, np.float32)
        times = np.asarray(times, np.float32)
        mask = np.ones(len(ball), np.float32)
        init_state = self.physics_seed(init, times) if init is not None else None
        n_frames = int(np.ceil((float(times.max()) + 1e-3) / 0.25)) * 125 + 2
        if "device" not in fit_kw:
            fit_kw["device"] = self.device
        res = fit_trajectory(ball, times, mask, np.asarray(Mint, np.float32),
                             np.asarray(Mext, np.float32), n_frames=n_frames,
                             init_state=init_state, **fit_kw)
        spin_local = G.transform_rotation_axes(res.state0.w, res.r_world)
        return spin_local.cpu().numpy(), res.r_world.cpu().numpy(), res

    @staticmethod
    def reproject(positions_3d, Mint, Mext, device="cuda"):
        """World points (..., 3) -> pixels (..., 2), in f32 on `device`."""
        dev = resolve_device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        return G.world2img(f32(positions_3d), f32(Mext), f32(Mint)).cpu().numpy()
