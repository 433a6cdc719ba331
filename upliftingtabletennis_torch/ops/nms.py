"""K6: greedy box NMS (suppression bitmask + greedy resolve), and OKS keypoint NMS.

Port of `upliftingtabletennis_tpu/ops/nms.py`. The semantics are those of the
reference's cpu_nms: boxes (x1, y1, x2, y2, score), +1-pixel areas, a box is
suppressed by a kept box of higher score whose IoU with it is >= thresh, and
boxes are visited in descending score order, ties in input order (a stable
sort, as the JAX function's `argsort(-score, stable=True)`).

Two phases, each a wrapper that dispatches on the tensor's device: CUDA
tensors go to the hand-written Hopper kernels of `csrc/nms.cu`, CPU tensors to
the plain PyTorch versions beside them. A build or launch failure raises;
nothing falls back to the plain version on CUDA.

- `overlap_words(boxes, thresh)`: boxes (N, 4) f32 in score order -> the
  (N, ceil(N / 64)) int64 suppression words; bit b of word w of row i is set
  when j = 64 w + b > i and IoU(i, j) >= thresh (`overlap_words_plain`).
- `resolve_words(words, order)`: the greedy scan over the rows in score order,
  written back to the original indexing through `order` (`resolve_plain`).

`nms_mask` composes them (two launches per call on CUDA) and `nms` returns
the kept indices in descending score order, as the JAX functions do.
`oks_iou`, `rescore`, `soft_oks_nms` and `oks_nms` run on the host in numpy,
as in the JAX package, of which they are a copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.ops import _build

__all__ = ["nms", "nms_mask", "overlap_words", "resolve_words", "overlap_words_plain",
           "resolve_plain", "pair_iou_plain", "pack_words", "unpack_words", "COCO_SIGMAS",
           "oks_iou", "rescore", "soft_oks_nms", "oks_nms"]

_SOURCE = "nms.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BITS = 64  # boxes per suppression word


def _n_words(n: int) -> int:
    return (n + BITS - 1) // BITS


def pair_iou_plain(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) boxes -> (N, N) f32 IoU with +1-pixel areas, in the JAX function's
    order of f32 operations."""
    b = boxes.float()
    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = (x2 - x1 + 1).clamp_min(0) * (y2 - y1 + 1).clamp_min(0)
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area[:, None] + area[None, :] - inter)


def pack_words(over: torch.Tensor) -> torch.Tensor:
    """(N, M) bool -> (N, ceil(M / 64)) int64: bit b of word w holds column 64 w + b."""
    n, m = over.shape
    bits = F.pad(over, (0, _n_words(m) * BITS - m)).view(n, _n_words(m), BITS).long()
    # distinct bits: the sum is their OR (bit 63 is the sign bit, summed without overflow)
    return (bits << torch.arange(BITS, device=over.device)).sum(-1)


def unpack_words(words: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of `pack_words`: (N, ceil(M / 64)) int64 -> (N, M) bool."""
    shifts = torch.arange(BITS, device=words.device)
    return ((words[..., None] >> shifts) & 1).bool().flatten(1)[:, :m]


def overlap_words_plain(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain PyTorch version of the mask kernel: the strict upper triangle of
    IoU >= thresh (f32, the threshold rounded to f32) as suppression words."""
    n = boxes.shape[0]
    over = pair_iou_plain(boxes) >= torch.tensor(thresh, dtype=torch.float32)
    over &= torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    return pack_words(over)


def resolve_plain(words: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the resolve kernel: the greedy scan of the JAX
    function's `fori_loop` (a box not yet suppressed suppresses its row), returned
    in the original indexing: keep[order[i]] for box i of the score order."""
    n = order.shape[0]
    over = unpack_words(words, n)
    removed = torch.zeros(n, dtype=torch.bool, device=words.device)
    for i in range(n):
        removed = removed | (over[i] & ~removed[i])
    keep = torch.empty_like(removed)
    keep[order] = ~removed
    return keep


def _lib():
    lib = _build.library(_SOURCE)
    if lib.uttk_nms_overlap.argtypes is None:
        lib.uttk_nms_overlap.argtypes = [_P, _I, _F, _P, _P]
        lib.uttk_nms_overlap.restype = _I
        lib.uttk_nms_resolve.argtypes = [_P, _P, _I, _P, _P]
        lib.uttk_nms_resolve.restype = _I
        lib.uttk_nms_max_boxes.argtypes = []
        lib.uttk_nms_max_boxes.restype = _I
    return lib


def _check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, lib) -> torch.Tensor:
    """A K6 operand: on CUDA, of `dtype`, contiguous and 16-byte aligned, at most
    the resolve's largest N rows."""
    if t.device.type != "cuda":
        raise RuntimeError(f"K6: no kernel for device {t.device}")
    if t.dtype != dtype:  # bf16 pixel coordinates would flip decisions
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if t.shape[0] > lib.uttk_nms_max_boxes():
        raise ValueError(f"{name}: at most {lib.uttk_nms_max_boxes()} boxes, got {t.shape[0]}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def overlap_words(boxes: torch.Tensor, thresh: float) -> torch.Tensor:
    """Suppression words of boxes (N, 4) f32 in descending score order:
    (N, ceil(N / 64)) int64, bit j % 64 of word j // 64 of row i set where j > i
    and IoU(i, j) >= thresh."""
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes: expected shape (N, 4), got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return overlap_words_plain(boxes, thresh)
    lib = _lib()
    boxes = _check_cuda(boxes, "boxes", torch.float32, lib)
    n = boxes.shape[0]
    out = torch.empty(n, _n_words(n), dtype=torch.int64, device=boxes.device)
    if n == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_nms_overlap(boxes.data_ptr(), n, float(thresh), out.data_ptr(), stream)
    _build.check(lib, status, "nms overlap")
    overlap_words.launches += 1
    return out


def resolve_words(words: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Greedy resolve of suppression words (N, ceil(N / 64)) whose rows are the
    boxes in score order; order (N,) int64 holds each row's original index.
    Returns the keep mask (N,) bool in the original indexing."""
    n = order.shape[0]
    if words.shape != (n, _n_words(n)):
        raise ValueError(f"words: expected shape {(n, _n_words(n))}, got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return resolve_plain(words, order)
    lib = _lib()
    words = _check_cuda(words, "words", torch.int64, lib)
    order = _check_cuda(order, "order", torch.int64, lib)
    keep = torch.empty(n, dtype=torch.bool, device=words.device)
    if n == 0:
        return keep
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.uttk_nms_resolve(words.data_ptr(), order.data_ptr(), n, keep.data_ptr(),
                                      stream)
    _build.check(lib, status, "nms resolve")
    resolve_words.launches += 1
    return keep


overlap_words.launches = 0
resolve_words.launches = 0


def score_order(dets: torch.Tensor) -> torch.Tensor:
    """Indices of dets (N, 5) by descending score, ties in input order."""
    return torch.sort(-dets[:, 4], stable=True).indices


def nms_mask(dets: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS of dets (N, 5) (x1, y1, x2, y2, score): the keep mask (N,) bool in
    the original indexing. CUDA tensors must be f32; CPU tensors are computed in f32."""
    if dets.ndim != 2 or dets.shape[1] < 5:
        raise ValueError(f"dets: expected shape (N, 5), got {tuple(dets.shape)}")
    if dets.device.type == "cpu":
        dets = dets.float()
    order = score_order(dets)
    return resolve_words(overlap_words(dets[order, :4], thresh), order)


def nms(dets, thresh: float, device="cuda") -> list:
    """Kept indices in descending score order (the cpu_nms contract) of dets (N, 5),
    run on `device` (the card unless the caller asks for the CPU)."""
    dets = np.asarray(dets, np.float32)
    if dets.shape[0] == 0:
        return []
    dev = resolve_device(device)
    keep = nms_mask(torch.from_numpy(dets).to(dev), thresh).cpu().numpy()
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-dets[idx, 4], kind="stable")].tolist()


# COCO keypoint sigmas (the standard per-joint falloff constants of the OKS
# metric, cocodataset.org/#keypoints-eval)
COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0


def oks_iou(g, d, a_g, a_d, sigmas=None, vis_thr=None):
    """Object-keypoint-similarity between one pose and N candidate poses, vectorized
    over candidates and joints. g (3K,), d (N, 3K), a_g scalar area, a_d (N,)."""
    if sigmas is None:
        sigmas = COCO_SIGMAS
    vars_ = (sigmas * 2) ** 2  # (K,)
    d = np.asarray(d, np.float64).reshape(len(d), -1, 3) if len(d) else np.zeros((0, len(vars_), 3))
    g = np.asarray(g, np.float64).reshape(-1, 3)
    a_d = np.asarray(a_d, np.float64)
    sq = (d[:, :, 0] - g[None, :, 0]) ** 2 + (d[:, :, 1] - g[None, :, 1]) ** 2  # (N, K)
    e = sq / vars_[None, :] / ((a_g + a_d[:, None]) / 2 + np.spacing(1)) / 2
    if vis_thr is not None:
        m = (g[None, :, 2] > vis_thr) & (d[:, :, 2] > vis_thr)  # (N, K)
        cnt = m.sum(axis=1)
        s = np.where(m, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1) if e.shape[1] else np.zeros(len(d))


def rescore(overlap, scores, thresh, type="gaussian"):
    """Soft-NMS score decay: linear above thresh, or gaussian exp(-overlap² / thresh)."""
    assert overlap.shape[0] == scores.shape[0]
    scores = scores.copy()
    if type == "linear":
        inds = np.where(overlap >= thresh)[0]
        scores[inds] = scores[inds] * (1 - overlap[inds])
    else:
        scores = scores * np.exp(-(overlap**2) / thresh)
    return scores


def soft_oks_nms(kpts_db, thresh, sigmas=None, vis_thr=None, max_dets=20):
    """Soft OKS NMS: greedy selection with gaussian score decay in place of hard
    suppression. kpts_db: dicts with "score", "keypoints" and "area"."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db], np.float64)
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db], np.float64)

    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr)
        order = order[1:]
        scores = rescore(ovr, scores[1:], thresh)
        resort = scores.argsort()[::-1]
        order = order[resort]
        scores = scores[resort]
        keep.append(int(i))
    return keep


def oks_nms(kpts_db, thr, sigmas=None, vis_thr=None):
    """Greedy OKS keypoint NMS: keep the best pose, drop those whose OKS with it
    exceeds thr, repeat."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([k["keypoints"].flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ious = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas, vis_thr)
        order = order[1:][ious <= thr]
    return keep
