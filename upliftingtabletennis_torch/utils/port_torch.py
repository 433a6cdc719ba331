"""The reference's own torch weights, mapped onto the port's state dicts.

Port of `upliftingtabletennis_tpu/utils/port_torch.py`. The JAX package maps a reference
state dict onto its flax tree; the port's modules are named after that tree
(`utils/convert.py`), so each map here is the JAX key rule followed by `flax_to_torch`'s
path rule, written as one direct map from the reference's keys to the port's. Tensors
keep torch's layouts, so a transpose in the JAX map and its inverse in `flax_to_torch`
cancel: what is left is a rename, and for SegFormer a repacking of the attention and
FFN weights.

* `port_uplifting_state_dict`: a reference uplifting `model_state_dict` -> the port's
  `models/uplifting.py` state dict (`a.layers.3.x` -> `a.layers_3.x`, `table_embed` and
  `pos_layers_i` moved under `table_stage`, the `rotary_emb.inv_freq` buffers dropped);
  `load_reference_checkpoint` reads a self-describing `.pt`.
* `port_cnn_state_dict`: a torch CNN / ViT state dict -> the port state dict of the same
  architecture, matched by key with '.' read as '_'; `partial=True` keeps a tensor whose
  key is missing or whose shape differs at its init value (the reference's filtered
  `load_state_dict(strict=False)`), counting as JAX counts.
* `torch_init_detector`: the reference's raw pretrained initial weights (WASB for the
  HRNet family, MAE for ViTPose), prefixed and with the first conv widened to
  3 * in_frames channels by tiling / in_frames.
* `port_segformerpp_state_dict`: a reference `segformerpp_*` (mmseg) checkpoint -> the
  port's `SegFormerNet(head_style="mmseg")` state dict.
* `port_hf_segformer_backbone`: a HuggingFace mit-bN encoder -> the port's MiT backbone.

Both SegFormer maps raise `UnmappedSegformerKeys` on a tensor they do not map.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["port_uplifting_state_dict", "load_reference_checkpoint", "port_cnn_state_dict",
           "torch_init_detector", "port_segformerpp_state_dict", "port_hf_segformer_backbone",
           "UnmappedSegformerKeys"]


def _tensor(v) -> torch.Tensor:
    """A value of a state dict (tensor or array) as an f32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def port_uplifting_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference uplifting `model_state_dict` -> the port model's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if "rotary_emb" in key:
            continue  # recomputed from the timestamps, not a parameter
        parts = key.split(".")
        names = []
        i = 0
        while i < len(parts):  # ModuleList indices join their list's name
            if i + 1 < len(parts) and re.fullmatch(r"\d+", parts[i + 1]):
                names.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                names.append(parts[i])
                i += 1
        for j, p in enumerate(names):  # the table tokens live under table_stage
            if p == "table_embed" or p.startswith("pos_layers_"):
                names = names[:j] + ["table_stage"] + names[j:]
                break
        out[".".join(names)] = _tensor(value)
    return out


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A reference `.pt` uplifting checkpoint ({'model_state_dict', 'identifier',
    'additional_info'}) -> (the port's state dict, additional_info), the architecture's
    options in the latter."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, Mapping) or "model_state_dict" not in ckpt:
        raise KeyError(f"{path}: not a reference uplifting checkpoint (no 'model_state_dict')")
    return port_uplifting_state_dict(ckpt["model_state_dict"]), ckpt.get("additional_info", {})


def port_cnn_state_dict(state_dict: Mapping[str, Any], target: Mapping[str, torch.Tensor],
                        partial: bool = False):
    """A torch state dict onto the port state dict `target` of the same network (its init
    values), matched by key with '.' read as '_' on both sides.

    A 4-D weight is taken as it is when its shape is the target's, else with its first
    two axes swapped (JAX's transposed-convolution branch); a 2-D weight as it is; a
    position embedding or token is reshaped when only its shape differs.
    partial=False: every target tensor must be given, at its shape (raises otherwise);
    returns the state dict. partial=True: a tensor whose key is missing or whose shape
    differs keeps its target value; returns (state dict, n_loaded, n_total), the counts
    over the target's parameters and running statistics (not `num_batches_tracked`)."""
    flat = {k.replace(".", "_"): v for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}
    out: Dict[str, torch.Tensor] = {}
    n_loaded = n_total = 0
    for key, init in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = init.clone()
            continue
        n_total += 1
        val = None
        src = flat.get(key.replace(".", "_"))
        if src is not None:
            a = _tensor(src)
            if a.ndim == 4 and a.shape != init.shape:
                a = a.transpose(0, 1)
            elif (a.shape != init.shape and a.numel() == init.numel()
                  and key.rsplit(".", 1)[-1] not in ("weight", "bias", "running_mean",
                                                     "running_var")):
                a = a.reshape(init.shape)
            if a.shape == init.shape:
                val = a.contiguous()
        if val is None:
            if not partial:
                raise KeyError(f"{key}: missing from the state dict or of another shape")
            out[key] = init.clone()
            continue
        n_loaded += 1
        out[key] = val
    if partial:
        return out, n_loaded, n_total
    return out


def torch_init_detector(target: Mapping[str, torch.Tensor], state_dict: Mapping[str, Any],
                        model_name: str, in_frames: int = 3):
    """The reference's raw pretrained initial weights (`initialization/wasb/model.pth` for
    the HRNet family, `mae_pretrain_vit_<size>.pth['model']` for ViTPose) onto the port
    state dict `target` (real init values: unmatched tensors keep them): a name- and
    shape-filtered load, after widening the first conv to 3 * in_frames input channels
    by tiling it and dividing by in_frames (a bias is kept). Returns (state dict,
    n_loaded, n_total)."""
    if model_name in ("wasb", "hrnet"):
        prefix, first_conv = "model.", "conv1.weight"
    elif model_name == "vitpose":
        prefix, first_conv = "model.backbone.", "patch_embed.proj.weight"
    else:
        raise ValueError(f"torch_init_detector supports wasb/hrnet/vitpose, got {model_name!r}"
                         " (segformer uses port_hf_segformer_backbone)")
    sd = {}
    for k, v in state_dict.items():
        a = _tensor(v)
        if k == first_conv and in_frames != 1 and a.ndim == 4 and a.shape[1] == 3:
            a = torch.cat([a] * in_frames, dim=1) / in_frames
        sd[prefix + k] = a
    return port_cnn_state_dict(sd, target, partial=True)


class UnmappedSegformerKeys(RuntimeError):
    """A SegFormer checkpoint holds tensors the map does not recognise (a fork's drift),
    reported with examples so that the map can be extended from the checkpoint itself."""


def _taker(sd: Dict[str, torch.Tensor]):
    unmapped = set(sd)

    def take(key):
        unmapped.discard(key)
        return sd[key]

    return take, unmapped


def _ffn_sublayers(sd, src):
    """MixFFN's three sublayers, told apart by shape: 1x1 (hid, C), the depthwise 3x3
    (hid, 1, 3, 3) and 1x1 (C, hid)."""
    ws = sorted(k for k in sd if re.fullmatch(re.escape(src) + r"ffn\.layers\.\d+\.weight", k))
    fc1 = dw = fc2 = None
    for k in ws:
        a = sd[k]
        if a.ndim == 4 and a.shape[1] == 1 and a.shape[2] == 3:
            dw = k
        elif a.ndim == 4 and a.shape[0] >= a.shape[1]:
            fc1 = k
        else:
            fc2 = k
    if None in (fc1, dw, fc2):
        raise UnmappedSegformerKeys(f"cannot identify MixFFN sublayers among {ws}")
    return fc1, dw, fc2


def port_segformerpp_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference `segformerpp_*` checkpoint (an mmseg `MixVisionTransformer` under
    `model.backbone.layers.{s}` and an mmseg `SegformerHead` under `model.decode_head`,
    the wrapper's widened first conv and `conv_seg` baked in; optionally
    `visible_classification`) -> the state dict of the port's
    `SegFormerNet(head_style="mmseg")`.

    The packed q|k|v `in_proj` of nn.MultiheadAttention splits into `attn.q` and a k|v
    `attn.kv`; MixFFN's 1x1 convs become linear weights. Raises UnmappedSegformerKeys on
    any tensor left unmapped."""
    sd = {k: _tensor(v) for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    take, unmapped = _taker(sd)
    out: Dict[str, torch.Tensor] = {}
    stages = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(r"model\.backbone\.layers\.(\d+)\.", k))})
    for s in stages:
        pre, bb = f"model.backbone.layers.{s}.", "backbone."
        out[f"{bb}patch_embed_{s}.weight"] = take(pre + "0.projection.weight")
        out[f"{bb}patch_embed_{s}.bias"] = take(pre + "0.projection.bias")
        out[f"{bb}patch_norm_{s}.weight"] = take(pre + "0.norm.weight")
        out[f"{bb}patch_norm_{s}.bias"] = take(pre + "0.norm.bias")
        out[f"{bb}stage_norm_{s}.weight"] = take(pre + "2.weight")
        out[f"{bb}stage_norm_{s}.bias"] = take(pre + "2.bias")
        blocks = sorted({int(m.group(1)) for k in sd
                         if (m := re.match(re.escape(pre) + r"1\.(\d+)\.", k))})
        for b in blocks:
            src, dst = pre + f"1.{b}.", f"{bb}stage{s}_block{b}."
            for norm in ("norm1", "norm2"):
                out[dst + norm + ".weight"] = take(src + norm + ".weight")
                out[dst + norm + ".bias"] = take(src + norm + ".bias")
            w = take(src + "attn.attn.in_proj_weight")
            bqkv = take(src + "attn.attn.in_proj_bias")
            C = w.shape[1]
            out[dst + "attn.q.weight"], out[dst + "attn.q.bias"] = w[:C], bqkv[:C]
            out[dst + "attn.kv.weight"], out[dst + "attn.kv.bias"] = w[C:], bqkv[C:]
            out[dst + "attn.proj.weight"] = take(src + "attn.attn.out_proj.weight")
            out[dst + "attn.proj.bias"] = take(src + "attn.attn.out_proj.bias")
            if src + "attn.sr.weight" in sd:
                out[dst + "attn.sr.weight"] = take(src + "attn.sr.weight")
                out[dst + "attn.sr.bias"] = take(src + "attn.sr.bias")
                out[dst + "attn.sr_norm.weight"] = take(src + "attn.norm.weight")
                out[dst + "attn.sr_norm.bias"] = take(src + "attn.norm.bias")
            fc1, dw, fc2 = _ffn_sublayers(sd, src)
            for name, k in (("fc1", fc1), ("dwconv", dw), ("fc2", fc2)):
                wk = take(k)
                out[dst + f"ffn.{name}.weight"] = wk if name == "dwconv" else wk[:, :, 0, 0]
                out[dst + f"ffn.{name}.bias"] = take(k[:-len("weight")] + "bias")

    def convmodule(src, conv, bn):
        out[conv + ".weight"] = take(src + ".conv.weight")
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{name}"] = take(f"{src}.bn.{name}")
        out[bn + ".num_batches_tracked"] = torch.tensor(0)

    convs = sorted({int(m.group(1)) for k in sd
                    if (m := re.match(r"model\.decode_head\.convs\.(\d+)\.", k))})
    for i in convs:
        convmodule(f"model.decode_head.convs.{i}", f"decode_head.conv_{i}", f"decode_head.bn_{i}")
    convmodule("model.decode_head.fusion_conv", "decode_head.fusion_conv", "decode_head.fusion_bn")
    out["decode_head.conv_seg.weight"] = take("model.decode_head.conv_seg.weight")
    out["decode_head.conv_seg.bias"] = take("model.decode_head.conv_seg.bias")
    if "visible_classification.weight" in sd:
        out["visible_classification.weight"] = take("visible_classification.weight")
        out["visible_classification.bias"] = take("visible_classification.bias")
    if unmapped:
        raise UnmappedSegformerKeys(f"{len(unmapped)} unrecognized tensors, e.g. "
                                    f"{sorted(unmapped)[:8]}")
    return out


def port_hf_segformer_backbone(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A HuggingFace `SegformerModel` / `SegformerForXxx` encoder state dict (keys under
    'segformer.encoder.' or 'encoder.'; others, such as a decode head, are ignored) ->
    the state dict of the port's MiT backbone (`SegFormerNet.backbone`). The query, key
    and value projections become `attn.q` and a k|v `attn.kv`. Raises
    UnmappedSegformerKeys on an encoder tensor it does not map."""
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("segformer.", "")
        if k.startswith("encoder."):
            sd[k[len("encoder."):]] = _tensor(v)
    take, unmapped = _taker(sd)
    out: Dict[str, torch.Tensor] = {}
    n_stages = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"patch_embeddings\.(\d+)\.", k)))
    for s in range(n_stages):
        pe = f"patch_embeddings.{s}."
        out[f"patch_embed_{s}.weight"] = take(pe + "proj.weight")
        out[f"patch_embed_{s}.bias"] = take(pe + "proj.bias")
        out[f"patch_norm_{s}.weight"] = take(pe + "layer_norm.weight")
        out[f"patch_norm_{s}.bias"] = take(pe + "layer_norm.bias")
        out[f"stage_norm_{s}.weight"] = take(f"layer_norm.{s}.weight")
        out[f"stage_norm_{s}.bias"] = take(f"layer_norm.{s}.bias")
        b = 0
        while f"block.{s}.{b}.layer_norm_1.weight" in sd:
            src, dst = f"block.{s}.{b}.", f"stage{s}_block{b}."
            at = src + "attention."
            for i in (1, 2):
                out[dst + f"norm{i}.weight"] = take(src + f"layer_norm_{i}.weight")
                out[dst + f"norm{i}.bias"] = take(src + f"layer_norm_{i}.bias")
            out[dst + "attn.q.weight"] = take(at + "self.query.weight")
            out[dst + "attn.q.bias"] = take(at + "self.query.bias")
            out[dst + "attn.kv.weight"] = torch.cat([take(at + "self.key.weight"),
                                                     take(at + "self.value.weight")])
            out[dst + "attn.kv.bias"] = torch.cat([take(at + "self.key.bias"),
                                                   take(at + "self.value.bias")])
            if at + "self.sr.weight" in sd:
                out[dst + "attn.sr.weight"] = take(at + "self.sr.weight")
                out[dst + "attn.sr.bias"] = take(at + "self.sr.bias")
                out[dst + "attn.sr_norm.weight"] = take(at + "self.layer_norm.weight")
                out[dst + "attn.sr_norm.bias"] = take(at + "self.layer_norm.bias")
            out[dst + "attn.proj.weight"] = take(at + "output.dense.weight")
            out[dst + "attn.proj.bias"] = take(at + "output.dense.bias")
            ml = src + "mlp."
            out[dst + "ffn.fc1.weight"] = take(ml + "dense1.weight")
            out[dst + "ffn.fc1.bias"] = take(ml + "dense1.bias")
            out[dst + "ffn.dwconv.weight"] = take(ml + "dwconv.dwconv.weight")
            out[dst + "ffn.dwconv.bias"] = take(ml + "dwconv.dwconv.bias")
            out[dst + "ffn.fc2.weight"] = take(ml + "dense2.weight")
            out[dst + "ffn.fc2.bias"] = take(ml + "dense2.bias")
            b += 1
    if unmapped:
        raise UnmappedSegformerKeys(f"{len(unmapped)} unrecognized encoder tensors, e.g. "
                                    f"{sorted(unmapped)[:8]}")
    return out
