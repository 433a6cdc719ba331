"""The work of one detector forward, from the published architectures as the configuration
file states them (never read from the port's modules, which later changes may rewrite).

Operations count the products (2 per multiply-add) of every convolution and matrix
product, attention's two included; normalisations, activations and resizes are not
counted. The SegFormer head is counted in its least form: each stage projected straight to
the decoder width (the MLP and its slice of the fuse layer merged, which is exact because
the bilinear resize is linear), then the 1x1 classifier, so that an implementation doing
less than counted cannot exist and no utilisation share passes 100%.
"""
from __future__ import annotations

from typing import Dict, List


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def mit_stages(seg: Dict, W: int, H: int) -> List[Dict]:
    """Per MiT stage at input (W, H): its token grid, width, heads, kv tokens and depth."""
    out = []
    for s, C in enumerate(seg["dims"]):
        k, st, p = (7, 4, 3) if s == 0 else (3, 2, 1)
        H, W = _conv_out(H, k, st, p), _conv_out(W, k, st, p)
        r = seg["sr_ratios"][s]
        nkv = (-(-H // r)) * (-(-W // r)) if r > 1 else H * W
        out.append({"H": H, "W": W, "N": H * W, "C": C, "heads": seg["heads"][s], "Nkv": nkv,
                     "sr": r, "depth": seg["depths"][s], "k": k})
    return out


def segformer_flops(seg: Dict, W: int, H: int, in_frames: int, out_channels: int) -> float:
    total, prev = 0.0, 3 * in_frames
    stages = mit_stages(seg, W, H)
    for st in stages:
        N, C, Nkv, r = st["N"], st["C"], st["Nkv"], st["sr"]
        total += 2 * N * st["k"] ** 2 * prev * C  # patch embedding
        hid = seg["mlp_ratio"] * C
        block = (2 * N * C * C * 2  # q and out projections
                 + (2 * Nkv * r * r * C * C if r > 1 else 0)  # the reduction conv
                 + 2 * Nkv * C * 2 * C  # the kv projection
                 + 2 * 2 * N * Nkv * C  # QK^T and PV
                 + 2 * 2 * N * C * hid  # fc1 and fc2
                 + 2 * 9 * N * hid)  # the depthwise 3x3
        total += st["depth"] * block
        prev = C
    D = seg["decoder_dim"]
    total += sum(2 * st["N"] * st["C"] * D for st in stages)  # each stage to the decoder width
    total += 2 * stages[0]["N"] * D * out_channels  # the classifier
    return total


def hrnet_convs(hr: Dict, W: int, H: int, in_frames: int, out_channels: int) -> List[Dict]:
    """Every convolution of one HRNet forward at input (W, H), in the order the published
    graph runs them: kernel, stride, channels in and out, output grid, and whether a residual
    is added in its epilogue (the second conv of a basic block, the third of a bottleneck)."""
    convs: List[Dict] = []

    def conv(ks, stride, ci, co, h, w, residual=False):
        ho, wo = _conv_out(h, ks, stride, ks // 2), _conv_out(w, ks, stride, ks // 2)
        convs.append({"ks": ks, "stride": stride, "Ci": ci, "Co": co, "H": ho, "W": wo,
                      "residual": residual})
        return ho, wo

    def block(kind, cin, planes, h, w):
        if kind == "BASIC":
            conv(3, 1, cin, planes, h, w)
            if cin != planes:
                conv(1, 1, cin, planes, h, w)
            conv(3, 1, planes, planes, h, w, residual=True)
            return planes
        out = 4 * planes
        conv(1, 1, cin, planes, h, w)
        conv(3, 1, planes, planes, h, w)
        if cin != out:
            conv(1, 1, cin, out, h, w)
        conv(1, 1, planes, out, h, w, residual=True)
        return out

    stem = hr["stem_inplanes"]
    s0, s1 = hr["stem_strides"]
    h, w = conv(3, s0, 3 * in_frames, stem, H, W)
    h, w = conv(3, s1, stem, stem, h, w)
    c = stem
    s1cfg = hr["stage1"]
    for _ in range(s1cfg["num_blocks"][0]):
        c = block(s1cfg["block"], c, s1cfg["num_channels"][0], h, w)
    chans, grids = [c], [(h, w)]
    for si in (2, 3, 4):
        scfg = hr[f"stage{si}"]
        exp = 1 if scfg["block"] == "BASIC" else 4
        cur = [n * exp for n in scfg["num_channels"]]
        new_grids = []
        for i, ci in enumerate(cur):
            if i < len(chans):
                if ci != chans[i]:
                    conv(3, 1, chans[i], ci, *grids[i])
                new_grids.append(grids[i])
            else:
                g, cin = grids[-1], chans[-1]
                for j in range(i + 1 - len(chans)):
                    co = ci if j == i - len(chans) else cin
                    g = conv(3, 2, cin, co, *g)
                    cin = co
                new_grids.append(g)
        for i, ci in enumerate(cur):  # the branches
            cin = ci
            for _ in range(scfg["num_blocks"][i]):
                cin = block(scfg["block"], cin, scfg["num_channels"][i], *new_grids[i])
        if len(cur) > 1:  # the fuse layers
            for i in range(len(cur)):
                for j in range(len(cur)):
                    if j > i:
                        conv(1, 1, cur[j], cur[i], *new_grids[j])
                    elif j < i:
                        g = new_grids[j]
                        for k in range(i - j):
                            co = cur[i] if k == i - j - 1 else cur[j]
                            g = conv(3, 2, cur[j], co, *g)
        chans, grids = cur, new_grids
    conv(hr["final_conv_kernel"], 1, chans[0], out_channels, *grids[0])
    return convs


def hrnet_flops(hr: Dict, W: int, H: int, in_frames: int, out_channels: int) -> float:
    return float(sum(2 * c["H"] * c["W"] * c["ks"] ** 2 * c["Ci"] * c["Co"]
                     for c in hrnet_convs(hr, W, H, in_frames, out_channels)))


def detector_flops(config: Dict, role: str) -> float:
    """Operations of one forward of the configuration's detector `role` on one frame."""
    det = config["detectors"][role]
    W, H = det["input_wh"]
    if det["arch"] == "segformer":
        return segformer_flops(config["segformer"][det["size"]], W, H, det["in_frames"],
                               det["out_channels"])
    return hrnet_flops(config["hrnet"], W, H, det["in_frames"], det["out_channels"])
