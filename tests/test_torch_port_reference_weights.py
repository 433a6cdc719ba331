"""The reference weights zip in the port (`utils/port_reference_weights.py`, `hub.
full_pipeline(weights_url=...)`) against the JAX package's converter.

A synthetic reference tree (no weight file is in the repo): WASB, the table HRNet and a
ViTPose ball detector from seeded port state dicts renamed to the reference's keys
(ModuleList indices as `.N`), the `ours` uplifting model (connectstage small, as
tests/test_torch_port_torch.py builds it), mmseg-named segformerpp b0 ball and table
checkpoints, a WASB under pretraining_blurball (its task read from the final layer), a
non-mmseg segformerpp (skipped) and a WASB with a tensor missing (FAILED).

* `port_tree` gives JAX's statuses on that tree, entry by entry (ok / skipped / FAILED);
* every converted checkpoint loads into its model, and the model's output equals, bit for
  bit, the same model loaded from the direct `utils/port_torch.py` map;
* `fetch_weights` over a `file://` zip keeps JAX's cache semantics
  (tests/test_port_reference_weights.py:544-575): the wrapping folder descended, the
  zip downloaded and extracted once, the cache serving after the source is gone; and
  `fetch_and_port` converts once (`.ported_ok`);
* `hub.full_pipeline(weights_url="file://...", device="cpu")` fills the WASB, table HRNet
  and uplifting slots with the converted weights (the b2 slots stay seeded).
"""
import os
import re
import zipfile

import numpy as np
import pytest
import torch

from test_torch_port_torch import _mmseg_b0, _random_like, _reference_uplifting_sd
from upliftingtabletennis_tpu.utils import port_reference_weights as JPRW
from upliftingtabletennis_torch import hub
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.utils import port_reference_weights as PRW
from upliftingtabletennis_torch.utils import port_torch as PP

torch.set_num_threads(2)
VIT_RES = (64, 64)


def _tame(state):
    """Seeded normal values made a network's: weights scaled by fan-in^-1/2, variances
    positive (the outputs stay finite, so that equal outputs mean something)."""
    out = {}
    for k, v in state.items():
        if k.endswith("running_var"):
            v = v.abs() + 0.5
        elif v.is_floating_point() and v.ndim >= 2:
            v = v * v[0].numel() ** -0.5
        out[k] = v
    return out


def _reference_cnn(name, task, seed, res=None):
    """A reference-format state dict of a port HRNet / ViTPose (seeded values)."""
    model, _ = get_detector(name, task, resolution=res)
    state = _tame(_random_like(model.state_dict(), seed))
    return {re.sub(r"_(\d+)", r".\1", k): v for k, v in state.items()}, model


def _save(src, rel, sd, info):
    d = os.path.join(src, rel)
    os.makedirs(d, exist_ok=True)
    torch.save({"model_state_dict": sd, "identifier": f"id_{rel}", "additional_info": info},
               os.path.join(d, "model.pt"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("ref") / "tt_weights")
    wasb, _ = _reference_cnn("wasb", "ball", 1)
    hrnet, _ = _reference_cnn("hrnet", "table", 2)
    vit, _ = _reference_cnn("vitpose", "ball", 3, VIT_RES)
    _save(src, "inference_balldetection/wasb", wasb,
          {"model_name": "wasb", "in_frames": 3, "image_resolution": (1280, 704)})
    _save(src, "inference_tabledetection/hrnet", hrnet,
          {"model_name": "hrnet", "image_resolution": (1280, 704)})
    _save(src, "inference_balldetection/vitpose", vit,
          {"model_name": "vitpose", "in_frames": 3, "image_resolution": VIT_RES})
    _save(src, "inference_uplifting/ours", _reference_uplifting_sd(4),
          {"name": "connectstage", "size": "small", "tabletoken_mode": "dynamic",
           "time_rotation": "new", "transform_mode": "global", "epoch": 1})
    spp_ball, spp_table = (_tame(_mmseg_b0(5 + i, classify=c)[0])
                           for i, c in enumerate((True, False)))
    spp_table["model.decode_head.conv_seg.weight"] = torch.randn(13, 64, 1, 1) / 8
    spp_table["model.decode_head.conv_seg.bias"] = torch.randn(13)
    spp_table["model.backbone.layers.0.0.projection.weight"] = (
        spp_table["model.backbone.layers.0.0.projection.weight"][:, :3].contiguous())
    _save(src, "inference_balldetection/segformerpp_b0", spp_ball,
          {"model_name": "segformerpp_b0", "in_frames": 3})
    _save(src, "inference_tabledetection/segformerpp_b0", spp_table,
          {"model_name": "segformerpp_b0"})
    _save(src, "pretraining_blurball/wasb", wasb, {"model_name": "wasb"})
    _save(src, "pretraining_blurball/segformerpp_b2", {"anything": torch.zeros(1)},
          {"model_name": "segformerpp_b2"})
    broken = dict(wasb)
    broken.pop("model.conv1.weight")
    _save(src, "pretraining_blurball/vitpose", broken, {"model_name": "wasb"})
    return src, {"wasb": wasb, "hrnet": hrnet, "vit": vit, "spp_ball": spp_ball,
                 "spp_table": spp_table}


@pytest.fixture(scope="module")
def ported(tree, tmp_path_factory):
    src, sds = tree
    dst = str(tmp_path_factory.mktemp("port"))
    return dst, PRW.main(["--src", src, "--dst", dst]), sds


def test_statuses_match_jax(tree, ported, tmp_path):
    src, _ = tree
    _, got, _ = ported
    want = JPRW.port_tree(src, str(tmp_path / "orbax"))
    assert sorted(got) == sorted(want)
    for rel, status in want.items():
        assert got[rel].split(":")[0] == status.split(":")[0], (rel, got[rel], status)
    assert sum(s == "ok" for s in got.values()) == 7
    assert got["pretraining_blurball/segformerpp_b2/model"].startswith("skipped")
    assert got["pretraining_blurball/vitpose/model"].startswith("FAILED: KeyError")


def _load(dst, rel):
    return torch.load(os.path.join(dst, rel, "model"), weights_only=True)


@pytest.mark.parametrize("rel,name,task,key,res", [
    ("inference_balldetection/wasb", "wasb", "ball", "wasb", None),
    ("inference_tabledetection/hrnet", "hrnet", "table", "hrnet", None),
    ("pretraining_blurball/wasb", "wasb", "ball", "wasb", None),
    ("inference_balldetection/vitpose", "vitpose", "ball", "vit", VIT_RES)],
    ids=["wasb", "hrnet", "pretraining_wasb", "vitpose"])
def test_detector_outputs_equal_the_direct_map(ported, rel, name, task, key, res):
    dst, _, sds = ported
    a, _ = get_detector(name, task, resolution=res)
    b, _ = get_detector(name, task, resolution=res)
    a.load_state_dict(_load(dst, rel))
    b.load_state_dict(PP.port_cnn_state_dict(sds[key], b.state_dict()))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 64, 64, 9 if task == "ball" else 3)).astype(np.float32))
    with torch.no_grad():
        ya, yb = a.eval()(x), b.eval()(x)
    ya, yb = (y[0] if isinstance(y, tuple) else y for y in (ya, yb))
    assert torch.equal(ya, yb)


@pytest.mark.parametrize("task", ["ball", "table"])
def test_segformerpp_outputs_equal_the_direct_map(ported, task):
    from upliftingtabletennis_torch.pipeline.interface import _architecture

    dst, _, sds = ported
    state = _load(dst, f"inference_{task}detection/segformerpp_b0")
    direct = PP.port_segformerpp_state_dict(sds[f"spp_{task}"])
    arch = _architecture(direct)
    a, _ = get_detector("segformerpp_b0", task, kernels=False, **arch)
    b, _ = get_detector("segformerpp_b0", task, kernels=False, **arch)
    a.load_state_dict(state)
    b.load_state_dict(direct)
    x = torch.randn(1, 64, 64, 3 * arch["in_frames"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(a.eval()(x)[0], b.eval()(x)[0])


def test_uplifting_output_equals_the_direct_map(ported):
    from upliftingtabletennis_torch.utils.checkpoint import load_model_from_checkpoint

    dst, _, _ = ported
    a, _, _, info = load_model_from_checkpoint(os.path.join(dst, "inference_uplifting/ours/model"))
    b = get_uplifting_model("connectstage", "small", "dynamic", "new").eval()
    b.load_state_dict(PP.port_uplifting_state_dict(_reference_uplifting_sd(4)))
    assert info["size"] == "small" and info["epoch"] == 1
    g = torch.Generator().manual_seed(0)
    inputs = (torch.rand(2, 20, 2, generator=g), torch.cat([torch.rand(2, 13, 2, generator=g),
                                                            torch.ones(2, 13, 1)], -1),
              torch.ones(2, 20), torch.arange(20.0)[None].repeat(2, 1) / 50)
    with torch.no_grad():
        for x, y in zip(a(*inputs), b(*inputs)):
            assert torch.equal(x, y)


def _zip(tmp_path, src, name="weights.zip"):
    zpath = tmp_path / name
    with zipfile.ZipFile(zpath, "w") as z:
        for dp, _, files in os.walk(src):
            for f in files:
                p = os.path.join(dp, f)
                z.write(p, os.path.relpath(p, os.path.dirname(src)))
    return zpath


def test_fetch_weights_file_url_caches_as_jax(tmp_path):
    src = tmp_path / "payload" / "tt_weights"
    (src / "inference_balldetection" / "wasb").mkdir(parents=True)
    (src / "inference_balldetection" / "wasb" / "model.pt").write_bytes(b"x")
    zpath = _zip(tmp_path, str(src))
    roots = {}
    for pkg, mod in (("port", PRW), ("jax", JPRW)):
        root = mod.fetch_weights(f"file://{zpath}", cache_dir=str(tmp_path / f"cache_{pkg}"))
        assert os.path.isfile(os.path.join(root, "inference_balldetection", "wasb", "model.pt"))
        roots[pkg] = os.path.relpath(root, tmp_path / f"cache_{pkg}")
    assert roots["port"] == roots["jax"] == os.path.join("weights.zip.extracted", "tt_weights")
    zpath.unlink()
    for pkg, mod in (("port", PRW), ("jax", JPRW)):
        again = mod.fetch_weights(f"file://{zpath}", cache_dir=str(tmp_path / f"cache_{pkg}"))
        assert os.path.relpath(again, tmp_path / f"cache_{pkg}") == roots[pkg]


def test_hub_full_pipeline_weights_url_fills_its_slots(tree, tmp_path, monkeypatch, capsys):
    src, sds = tree
    zpath = _zip(tmp_path, src, "tt_weights.zip")
    monkeypatch.setattr(PRW, "CACHE_DIR", str(tmp_path / "cache"))
    pipe = hub.full_pipeline(weights_url=f"file://{zpath}", device="cpu")
    root = tmp_path / "cache" / "tt_weights.zip.extracted" / "tt_weights.port"
    assert (root / ".ported_ok").is_file()
    for det, key in ((pipe.ball_detector_aux, "wasb"), (pipe.table_detector_aux, "hrnet")):
        want = PP.port_cnn_state_dict(sds[key], det.model.state_dict())
        for k, v in det.model.state_dict().items():
            assert torch.equal(v, want[k]), (key, k)
    want = PP.port_uplifting_state_dict(_reference_uplifting_sd(4))
    for k, v in pipe.uplifting_model.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    capsys.readouterr()
    hub.full_pipeline(weights_url=f"file://{zpath}", device="cpu")  # from the cache
    out = capsys.readouterr().out
    assert "downloading" not in out and "extracting" not in out and " ok" not in out
