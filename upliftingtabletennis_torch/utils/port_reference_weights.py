"""Convert the reference's released weights zip into the port's checkpoints.

Port of `upliftingtabletennis_tpu/utils/port_reference_weights.py`. The reference's zip
holds

    inference_balldetection/{segformerpp_b0,segformerpp_b2,wasb,vitpose}/model.pt
    inference_tabledetection/{segformerpp_b0,segformerpp_b2,vitpose,hrnet}/model.pt
    inference_uplifting/{kienzleetal,mixed,ours}/model.pt
    pretraining_blurball/{segformerpp_b0,segformerpp_b2,wasb,vitpose}/model.pt
    initialization/...

each `model.pt` a self-describing torch checkpoint ({'model_state_dict', 'identifier',
'additional_info'}). `port_tree` walks that layout and writes the port's checkpoints
(`utils/checkpoint.py`: a state dict at `<rel>/model`, its metadata at `<rel>/model.json`)
at the same relative paths, the layout `hub.full_pipeline(weights_root=...)` reads:

    python -m upliftingtabletennis_torch.utils.port_reference_weights \\
        --src <unzipped reference weights> --dst <weights root>

The maps are `utils/port_torch.py`'s: uplifting checkpoints by `port_uplifting_state_dict`;
wasb / hrnet / vitpose by `port_cnn_state_dict` onto the port model the checkpoint's
`additional_info` describes (model_name, in_frames, image_resolution; the task from the
final layer's channels when not given); segformerpp_* (mmseg-named) by
`port_segformerpp_state_dict`, checked tensor by tensor against
`SegFormerNet(head_style="mmseg")`. A layout the maps do not know is skipped with its
reason, any other error reported as FAILED, and the walk goes on; `initialization/` (raw
training-time init weights) is not converted.

`fetch_weights` downloads (anything urllib opens: https://, file:// or a bare path) and
extracts the zip once into a cache (`~/.cache/upliftingtabletennis_torch/weights`), and
`fetch_and_port` converts it once beside the extraction (`<extraction>.port`); later
calls return the cached result, as the reference's hub download does.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["UnsupportedCheckpoint", "port_uplifting_checkpoint", "port_detector_checkpoint",
           "port_tree", "fetch_weights", "fetch_and_port", "main", "CACHE_DIR"]

CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "upliftingtabletennis_torch",
                         "weights")
PORT_SUFFIX = ".port"  # the converted tree beside an extracted zip


class UnsupportedCheckpoint(RuntimeError):
    """A checkpoint whose layout the maps do not cover (reported, not raised, by
    `port_tree`)."""


def _json_safe(obj):
    """additional_info as JSON: tuples as lists, numpy scalars as Python numbers, other
    objects as their str."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _load(pt_path: str) -> dict:
    return torch.load(pt_path, map_location="cpu", weights_only=False)


def port_uplifting_checkpoint(pt_path: str) -> Tuple[Dict[str, torch.Tensor], str, Dict]:
    """A reference uplifting model.pt -> (the port's state dict, identifier, info)."""
    from upliftingtabletennis_torch.utils.port_torch import port_uplifting_state_dict

    ckpt = _load(pt_path)
    state = port_uplifting_state_dict(ckpt["model_state_dict"])
    return state, ckpt.get("identifier", ""), _json_safe(ckpt.get("additional_info", {}))


def port_detector_checkpoint(pt_path: str, task: Optional[str] = None
                             ) -> Tuple[Dict[str, torch.Tensor], str, Dict, str]:
    """A reference detector model.pt -> (the port's state dict, identifier, info, name).

    The architecture comes from additional_info (model_name, in_frames,
    image_resolution); task None is inferred from the final layer's out channels (1 ball,
    13 table)."""
    from upliftingtabletennis_torch.models.factory import DETECTOR_RESOLUTIONS, get_detector
    from upliftingtabletennis_torch.utils.port_torch import port_cnn_state_dict

    ckpt = _load(pt_path)
    info = ckpt.get("additional_info", {})
    sd = ckpt["model_state_dict"]
    name = info.get("model_name")
    if name is None:
        raise UnsupportedCheckpoint(f"{pt_path}: no model_name in additional_info")
    if name.startswith("segformerpp"):
        return _port_segformerpp_checkpoint(ckpt, name, task, pt_path)
    if task is None:
        out_ch = None
        for key in ("model.final_layers.0.weight", "model.keypoint_head.final_layer.weight"):
            if key in sd:
                out_ch = sd[key].shape[0]
        if out_ch is None:
            raise UnsupportedCheckpoint(f"{pt_path}: cannot infer task (no final layer)")
        task = "table" if out_ch == 13 else "ball"
    in_frames = int(info.get("in_frames", 3 if task == "ball" else 1))
    res = tuple(info.get("image_resolution", DETECTOR_RESOLUTIONS[name]))  # (W, H)
    model, _ = get_detector(name, task, in_frames=in_frames, resolution=res)
    state = port_cnn_state_dict(sd, model.state_dict())
    return state, ckpt.get("identifier", ""), _json_safe(info), name


def _port_segformerpp_checkpoint(ckpt, name, task, pt_path):
    """segformerpp_* (an mmseg MixVisionTransformer and SegformerHead): mapped by
    `port_segformerpp_state_dict` and checked, tensor by tensor, against the
    `SegFormerNet(head_style="mmseg")` the tensors describe."""
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.utils.port_torch import (UnmappedSegformerKeys,
                                                            port_segformerpp_state_dict)

    info = dict(ckpt.get("additional_info", {}))
    sd = dict(ckpt["model_state_dict"])
    fuse_key = "model.decode_head.fusion_conv.conv.weight"
    seg_key = "model.decode_head.conv_seg.weight"
    if fuse_key not in sd or seg_key not in sd:
        raise UnsupportedCheckpoint(f"{pt_path}: not an mmseg SegformerHead layout "
                                    f"(missing {fuse_key!r}) - cannot port")
    decoder_dim = int(sd[fuse_key].shape[0])
    out_ch = int(sd[seg_key].shape[0])
    if task is None:
        task = "table" if out_ch == 13 else "ball"
    classify = "visible_classification.weight" in sd
    in_frames = max(1, int(sd["model.backbone.layers.0.0.projection.weight"].shape[1]) // 3)
    try:
        state = port_segformerpp_state_dict(sd)
    except UnmappedSegformerKeys as e:
        raise UnsupportedCheckpoint(f"{pt_path}: {e}") from e
    model, _ = get_detector(name, task, in_frames=in_frames, classify_invisible=classify,
                            head_style="mmseg", decoder_dim=decoder_dim)
    got = {k: tuple(v.shape) for k, v in state.items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if got != want:
        extra = sorted(set(got) - set(want))[:4]
        missing = sorted(set(want) - set(got))[:4]
        mism = sorted(k for k in got.keys() & want.keys() if got[k] != want[k])[:4]
        raise UnsupportedCheckpoint(f"{pt_path}: the ported tensors do not fit "
                                    f"SegFormerNet(mmseg): extra={extra} missing={missing} "
                                    f"shape-mismatch={mism}")
    info.update(flax_head_style="mmseg", decoder_dim=decoder_dim, in_frames=in_frames,
                classify_invisible=classify, model_name=name)
    return state, ckpt.get("identifier", ""), _json_safe(info), name


# the layout's directories -> (kind, task or None)
_LAYOUT = (
    ("inference_balldetection", "detector", "ball"),
    ("inference_tabledetection", "detector", "table"),
    ("pretraining_blurball", "detector", None),
    ("inference_uplifting", "uplifting", None),
)


def port_tree(src: str, dst: str) -> Dict[str, str]:
    """Convert an unzipped reference weights tree at src into the port's checkpoints at
    the same relative paths under dst. Returns {relpath: "ok" | "skipped: ..." |
    "FAILED: ..."}."""
    from upliftingtabletennis_torch.utils.checkpoint import save_checkpoint

    results: Dict[str, str] = {}
    for sub, kind, task in _LAYOUT:
        root = os.path.join(src, sub)
        if not os.path.isdir(root):
            continue
        for entry in sorted(os.listdir(root)):
            pt = os.path.join(root, entry, "model.pt")
            rel = os.path.join(sub, entry, "model")
            if not os.path.isfile(pt):
                continue
            try:
                if kind == "uplifting":
                    state, ident, info = port_uplifting_checkpoint(pt)
                else:
                    state, ident, info, _ = port_detector_checkpoint(pt, task)
                save_checkpoint(os.path.join(dst, rel), state, ident, info)
                results[rel] = "ok"
            except UnsupportedCheckpoint as e:
                results[rel] = f"skipped: {e}"
            except Exception as e:  # keep walking; reported at the end
                results[rel] = f"FAILED: {type(e).__name__}: {e}"
    return results


def _layout_root(path: str) -> str:
    """The directory under an extraction that holds the layout: descend through single
    wrapping folders, ignoring zip junk and a converted tree beside it."""
    entries = [e for e in os.listdir(path)
               if not e.startswith("__MACOSX") and not e.endswith(PORT_SUFFIX)]
    if any(e.startswith(("inference_", "pretraining_", "initialization")) for e in entries):
        return path
    if len(entries) == 1 and os.path.isdir(os.path.join(path, entries[0])):
        return _layout_root(os.path.join(path, entries[0]))
    return path


def fetch_weights(url: str, cache_dir: Optional[str] = None, force: bool = False) -> str:
    """Download and extract the reference weights zip; returns the layout's root.

    The zip is downloaded once into cache_dir (default CACHE_DIR) and extracted once;
    later calls return the extraction without opening `url`. url: anything urllib opens
    (https://, file://) or a bare local path. force: download and extract again."""
    import urllib.parse
    import urllib.request
    import zipfile

    cache_dir = CACHE_DIR if cache_dir is None else cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    if "://" not in url:
        url = "file://" + os.path.abspath(url)
    name = os.path.basename(urllib.parse.urlparse(url).path) or "weights.zip"
    zip_path = os.path.join(cache_dir, name)
    extract_path = os.path.join(cache_dir, name + ".extracted")
    if force:
        for p in (zip_path, extract_path):
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.isfile(p):
                os.remove(p)
    if os.path.isdir(extract_path):
        return _layout_root(extract_path)
    if not os.path.isfile(zip_path):
        print(f"[fetch_weights] downloading {url} -> {zip_path}")
        tmp = zip_path + ".part"
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f, 1 << 20)
        os.replace(tmp, zip_path)
    print(f"[fetch_weights] extracting {zip_path}")
    tmp_extract = extract_path + ".part"
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(tmp_extract)
    os.replace(tmp_extract, extract_path)
    return _layout_root(extract_path)


def fetch_and_port(url: str, dst: Optional[str] = None, cache_dir: Optional[str] = None,
                   force: bool = False) -> str:
    """`fetch_weights` then `port_tree`, cached: returns the converted weights root
    (default `<layout root>.port`), converting only when it holds no finished conversion
    (its `.ported_ok` marker, written when at least one checkpoint converted)."""
    src = fetch_weights(url, cache_dir, force)
    if dst is None:
        dst = src + PORT_SUFFIX
    done_marker = os.path.join(dst, ".ported_ok")
    if not force and os.path.isfile(done_marker):
        return dst
    results = port_tree(src, dst)
    if any(s == "ok" for s in results.values()):
        with open(done_marker, "w") as f:
            f.write("\n".join(f"{k}\t{v}" for k, v in results.items()))
    for rel, status in results.items():
        print(f"{rel}  {status}")
    return dst


def main(argv=None) -> Dict[str, str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--src", help="unzipped reference weights directory")
    g.add_argument("--url", help="weights zip URL (https:// or file://), downloaded and "
                                 "extracted into the cache")
    p.add_argument("--dst", required=True, help="output root (the same sub-layout)")
    args = p.parse_args(argv)

    src = args.src if args.src else fetch_weights(args.url)
    results = port_tree(src, args.dst)
    width = max((len(k) for k in results), default=0)
    for rel, status in results.items():
        print(f"{rel:<{width}}  {status}")
    n_ok = sum(1 for s in results.values() if s == "ok")
    print(f"[port_reference_weights] converted {n_ok}/{len(results)} checkpoints -> {args.dst}")
    return results


if __name__ == "__main__":
    main()
