"""The port's reference-weight maps (`utils/port_torch.py`) against the JAX package's.

Every map is held as JAX's map followed by `utils/convert.py:flax_to_torch` against the
port's direct map, on synthetic state dicts in the reference's formats (no weight file
is in the repo): the tensors must be equal, bit for bit.

* uplifting: a reference `model_state_dict` made from the port model's own keys
  (ModuleList indices as `.N`, the table tokens outside `table_stage`, `rotary_emb`
  buffers added); `UpliftingModel.from_reference_checkpoint` and `run_uplifting_eval`'s
  `.pt` route on a synthetic `.pt`, against JAX's `from_reference_checkpoint` (spin and
  positions within 1e-4 of their max);
* `port_cnn_state_dict` (WASB, ViTPose), full and partial: missing keys and wrong shapes
  keep the init values, n_loaded / n_total equal JAX's;
* `torch_init_detector`: WASB's `model.pth` (first conv widened from 3 to 9 channels)
  and an MAE ViT-S (`blocks.*`, `patch_embed.proj`, a 197-row `pos_embed` that does not
  fit a 64x64 model, `norm.*` and `cls_token` that it has no place for);
* `port_segformerpp_state_dict` (an mmseg-named b0 with the mmseg head and the
  visibility classifier) and `port_hf_segformer_backbone` (a HuggingFace `SegformerModel`
  at b0 geometry); `UnmappedSegformerKeys` on an unknown tensor;
* the trainer CLI: `--torch_init` on an MAE file (`["model"]` layout) prints JAX's
  counts, `--hf_backbone` loads the tiled encoder, and a missing file raises.
"""
import glob
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector
from upliftingtabletennis_tpu.utils import port_torch as JP
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.utils import port_torch as PP
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)


def _assert_equal_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k].float()), k


def _random_like(state, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v.clone())
            for k, v in state.items()}


def _reference_uplifting_sd(seed=0):
    """A reference-format uplifting `model_state_dict` for connectstage small."""
    port = get_uplifting_model("connectstage", "small", "dynamic", "new")
    sd = {}
    for k, v in _random_like(port.state_dict(), seed).items():
        k = k.replace("table_stage.", "")
        k = ".".join(re.sub(r"^(.+)_(\d+)$", r"\1.\2", p) for p in k.split("."))
        sd[k] = v
        if k.endswith("attn.qkv.weight"):  # the reference's rotary buffers
            sd[k.replace("qkv.weight", "rotary_emb.inv_freq")] = torch.rand(4)
    return sd


def test_uplifting_map_matches_jax():
    sd = _reference_uplifting_sd()
    got = PP.port_uplifting_state_dict(sd)
    want = flax_to_torch({"params": JP.port_uplifting_state_dict(sd)})
    _assert_equal_state(got, want)
    model = get_uplifting_model("connectstage", "small", "dynamic", "new")
    model.load_state_dict(got, strict=True)


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "uplifting.pt"
    info = {"name": "connectstage", "size": "small", "tabletoken_mode": "dynamic",
            "time_rotation": "new", "transform_mode": "local"}
    sd = {k: v * 0.3 for k, v in _reference_uplifting_sd(1).items()}
    torch.save({"model_state_dict": sd, "identifier": "ref", "additional_info": info}, path)
    return str(path)


def test_from_reference_checkpoint_matches_jax(reference_pt):
    from upliftingtabletennis_tpu.pipeline.interface import UpliftingModel as JaxUplifting
    from upliftingtabletennis_torch.eval.run_uplifting_eval import load_uplifting
    from upliftingtabletennis_torch.pipeline.interface import UpliftingModel

    rng = np.random.default_rng(2)
    T = 30
    ball = np.stack([np.linspace(300, 1500, T), 500 + 100 * np.sin(np.linspace(0, 3, T))], 1)
    ball = (ball + rng.normal(0, 2, ball.shape)).astype(np.float32)
    table = np.concatenate([rng.uniform([400, 500], [1500, 900], (13, 2)),
                            np.ones((13, 1))], 1).astype(np.float32)
    times = (np.arange(T) / 50.0).astype(np.float32)
    jax_model = JaxUplifting.from_reference_checkpoint(reference_pt)
    want_rot, want_pos = jax_model.predict(ball, table, times)
    port = UpliftingModel.from_reference_checkpoint(reference_pt, device="cpu")
    assert port.transform_mode == jax_model.transform_mode == "local"
    rot, pos = port.predict(ball, table, times)
    assert pos.shape == want_pos.shape
    for got, want in ((rot, want_rot), (pos, want_pos)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # run_uplifting_eval's .pt route loads the same model
    model, tm = load_uplifting(reference_pt, "cpu")
    assert tm == "local"
    for a, b in zip(model.state_dict().values(), port.model.state_dict().values()):
        assert torch.equal(a, b)


def test_reference_checkpoint_needs_a_model_state_dict(tmp_path):
    torch.save({"weights": {}}, tmp_path / "x.pt")
    with pytest.raises(KeyError, match="model_state_dict"):
        PP.load_reference_checkpoint(str(tmp_path / "x.pt"))


def _jax_variables(name, task, res, in_frames=None):
    """JAX init variables of a detector at (W, H), numpy."""
    model, _ = jax_get_detector(name, task, in_frames=in_frames)
    W, H = res
    c = 3 * (in_frames or (3 if task == "ball" else 1))
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, c))))


def _flax_counts(variables):
    return sum(len(jax.tree_util.tree_leaves(v)) for v in variables.values())


@pytest.mark.parametrize("name,task", [("wasb", "ball"), ("vitpose", "table")])
def test_cnn_map_full_and_partial_match_jax(name, task):
    res = (64, 64)
    variables = _jax_variables(name, task, res)
    target = flax_to_torch(variables)
    assert len([k for k in target if not k.endswith("tracked")]) == _flax_counts(variables)
    # a reference-format state dict of the whole network: '.' for every '_' of a module
    full = {k.replace("_", "."): v for k, v in _random_like(target, 3).items()}
    got = PP.port_cnn_state_dict(full, target)
    want = flax_to_torch(JP.port_cnn_state_dict(full, variables))
    _assert_equal_state(got, {k: want.get(k, target[k]) for k in target})
    # partial: drop some keys, give others the wrong shape
    keys = sorted(k for k in full if not k.endswith("tracked"))
    part = {k: v for i, (k, v) in enumerate(sorted(full.items())) if i % 7 != 3}
    for k in keys[5::11]:
        if k in part and part[k].ndim >= 1:
            part[k] = torch.zeros(*part[k].shape[:-1], part[k].shape[-1] + 1)
    got, n_loaded, n_total = PP.port_cnn_state_dict(part, target, partial=True)
    want, j_loaded, j_total = JP.port_cnn_state_dict(part, variables, partial=True)
    assert (n_loaded, n_total) == (j_loaded, j_total) and 0 < n_loaded < n_total
    want = flax_to_torch(want)
    _assert_equal_state(got, {k: want.get(k, target[k]) for k in target})
    with pytest.raises(KeyError):
        PP.port_cnn_state_dict(part, target)


def _mae_state_dict(seed=0):
    """An MAE ViT-S state dict (`mae_pretrain_vit_small.pth['model']`): 3 input channels,
    a cls token and a 197-row position embedding, a final `norm` (the card check's)."""
    from chip_smoke import mae_state_dict

    return mae_state_dict(torch, seed)


def _wasb_init_state_dict(target, seed=0):
    """WASB's published `model.pth`: the network's tensors under their torch names, its
    first conv for 3 channels."""
    sd = {k[len("model."):].replace("_", "."): v for k, v in _random_like(target, seed).items()
          if k.startswith("model.")}
    sd["conv1.weight"] = sd["conv1.weight"][:, :3].clone()
    return sd


@pytest.mark.parametrize("name,task,in_frames", [("wasb", "ball", 3), ("vitpose", "ball", 3),
                                                 ("vitpose", "table", 1)])
def test_torch_init_detector_matches_jax(name, task, in_frames):
    variables = _jax_variables(name, task, (64, 64), in_frames)
    target = flax_to_torch(variables)
    sd = _wasb_init_state_dict(target) if name == "wasb" else _mae_state_dict()
    if name == "vitpose":  # a grid the 64x64 model has (4x4): the embedding loads too
        sd_fit = dict(sd, pos_embed=torch.randn(1, 17, 384))
    got, n_loaded, n_total = PP.torch_init_detector(target, sd, name, in_frames)
    want, j_loaded, j_total = JP.torch_init_detector(variables, sd, name, in_frames)
    assert (n_loaded, n_total) == (j_loaded, j_total)
    _assert_equal_state(got, flax_to_torch(want))
    first = "model.conv1.weight" if name == "wasb" else "model_backbone.patch_embed_proj.weight"
    src = sd["conv1.weight" if name == "wasb" else "patch_embed.proj.weight"]
    assert torch.equal(got[first], torch.cat([src] * in_frames, 1) / in_frames)
    if name == "vitpose":
        assert torch.equal(got["model_backbone.pos_embed"], target["model_backbone.pos_embed"])
        got2, n2, _ = PP.torch_init_detector(target, sd_fit, name, in_frames)
        want2, j2, _ = JP.torch_init_detector(variables, sd_fit, name, in_frames)
        assert n2 == j2 == n_loaded + 1
        _assert_equal_state(got2, flax_to_torch(want2))
    with pytest.raises(ValueError, match="segformer"):
        PP.torch_init_detector(target, sd, "segformerpp_b0")


def _hf_b0(seed=0):
    from transformers import SegformerConfig, SegformerModel

    torch.manual_seed(seed)
    cfg = SegformerConfig(num_channels=3, num_encoder_blocks=4, depths=[2, 2, 2, 2],
                          sr_ratios=[8, 4, 2, 1], hidden_sizes=[32, 64, 160, 256],
                          patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
                          num_attention_heads=[1, 2, 5, 8], mlp_ratios=[4, 4, 4, 4],
                          layer_norm_eps=1e-6)
    return SegformerModel(cfg).state_dict()


def test_hf_backbone_map_matches_jax():
    sd = _hf_b0()
    got = PP.port_hf_segformer_backbone(sd)
    want = flax_to_torch({"params": JP.port_hf_segformer_backbone(sd)})
    _assert_equal_state(got, want)
    model, _ = get_detector("segformerpp_b0", "table")
    model.backbone.load_state_dict(got, strict=True)
    with pytest.raises(PP.UnmappedSegformerKeys):
        PP.port_hf_segformer_backbone({**sd, "encoder.block.0.0.extra.weight": torch.zeros(3)})


def _mmseg_b0(seed=0, classify=True):
    """A reference segformerpp checkpoint at b0 geometry (mmseg names), from the port's
    `head_style="mmseg"` model's tensors."""
    model, _ = get_detector("segformerpp_b0", "ball", head_style="mmseg", decoder_dim=64,
                            classify_invisible=classify)
    src = _random_like(model.state_dict(), seed)
    sd = {}
    for k, v in src.items():
        if m := re.match(r"backbone\.(patch_embed|patch_norm)_(\d)\.(\w+)$", k):
            kind, s, leaf = m.groups()
            sd[f"model.backbone.layers.{s}.0.{'projection' if kind == 'patch_embed' else 'norm'}"
               f".{leaf}"] = v
        elif m := re.match(r"backbone\.stage_norm_(\d)\.(\w+)$", k):
            sd[f"model.backbone.layers.{m.group(1)}.2.{m.group(2)}"] = v
        elif m := re.match(r"backbone\.stage(\d)_block(\d)\.(.+)\.(\w+)$", k):
            s, b, mod, leaf = m.groups()
            pre = f"model.backbone.layers.{s}.1.{b}."
            if mod in ("norm1", "norm2"):
                sd[pre + f"{mod}.{leaf}"] = v
            elif mod == "attn.proj":
                sd[pre + f"attn.attn.out_proj.{leaf}"] = v
            elif mod == "attn.sr":
                sd[pre + f"attn.sr.{leaf}"] = v
            elif mod == "attn.sr_norm":
                sd[pre + f"attn.norm.{leaf}"] = v
            elif mod == "attn.q":
                kv = src[k.replace("attn.q", "attn.kv")]
                sd[pre + f"attn.attn.in_proj_{leaf}"] = torch.cat([v, kv])
            elif mod == "ffn.fc1":
                sd[pre + f"ffn.layers.0.{leaf}"] = v[..., None, None] if leaf == "weight" else v
            elif mod == "ffn.dwconv":
                sd[pre + f"ffn.layers.1.{leaf}"] = v
            elif mod == "ffn.fc2":
                sd[pre + f"ffn.layers.4.{leaf}"] = v[..., None, None] if leaf == "weight" else v
        elif m := re.match(r"decode_head\.(conv|bn)_(\d)\.(\w+)$", k):
            kind, i, leaf = m.groups()
            sd[f"model.decode_head.convs.{i}.{kind}.{leaf}"] = v
        elif m := re.match(r"decode_head\.fusion_(conv|bn)\.(\w+)$", k):
            sd[f"model.decode_head.fusion_conv.{m.group(1)}.{m.group(2)}"] = v
        elif k.startswith(("decode_head.conv_seg", "visible_classification")):
            sd[k if k.startswith("visible") else "model." + k] = v
    return sd, model


@pytest.mark.parametrize("classify", [True, False], ids=["classify", "plain"])
def test_segformerpp_map_matches_jax(classify):
    sd, model = _mmseg_b0(classify=classify)
    got = PP.port_segformerpp_state_dict(sd)
    want = flax_to_torch(JP.port_segformerpp_state_dict(sd))
    _assert_equal_state(got, want)
    model.load_state_dict(got, strict=True)
    for fn in (PP.port_segformerpp_state_dict, JP.port_segformerpp_state_dict):
        with pytest.raises(JP.UnmappedSegformerKeys if fn is JP.port_segformerpp_state_dict
                           else PP.UnmappedSegformerKeys):
            fn({**sd, "model.decode_head.extra.weight": torch.zeros(2)})


@pytest.fixture(scope="module")
def tiny_tthq(tmp_path_factory):
    """2 videos of 8 96x128 frames with a ball blob (the trainer tests' layout)."""
    import cv2

    root = tmp_path_factory.mktemp("data")
    tthq = root / "tthq"
    rng = np.random.default_rng(0)
    rows = ["video;frame;ball_x;ball_y;ball_flag"]
    for video in (1, 2):
        vdir = tthq / f"{video:02d}"
        vdir.mkdir(parents=True)
        for frame in range(8):
            img = rng.integers(0, 60, (96, 128, 3), dtype=np.uint8)
            bx, by = rng.uniform(10, 118), rng.uniform(10, 86)
            cv2.circle(img, (int(bx), int(by)), 3, (255, 255, 255), -1)
            cv2.imwrite(str(vdir / f"{video:02d}_{frame:06d}.png"), img)
            if 1 <= frame <= 6:
                rows.append(f"{video};{frame};{bx:.1f};{by:.1f};2")
    (tthq / "ball_detection.csv").write_text("\n".join(rows))
    return str(root)


def _cli(root, tmp_path, *flags):
    from upliftingtabletennis_torch.train import run_detection as T

    T.main(["--task", "ball", "--data_root", root, "--batch_size", "2", "--num_epochs", "1",
            "--val_iterations", "1", "--max_steps", "1", "--eval_resolution", "128", "96",
            "--save_dir", str(tmp_path / "ckpt"), "--logdir", str(tmp_path / "runs"),
            "--device", "cpu", *flags])


def test_cli_torch_init_prints_jax_counts(tiny_tthq, tmp_path, capsys):
    path = tmp_path / "mae_pretrain_vit_small.pth"
    torch.save({"model": _mae_state_dict(seed=4)}, path)  # the MAE layout
    _cli(tiny_tthq, tmp_path, "--model", "vitpose", "--resolution", "64", "64",
         "--torch_init", str(path))
    variables = _jax_variables("vitpose", "ball", (64, 64))
    _, n, m = JP.torch_init_detector(variables, _mae_state_dict(seed=4), "vitpose", 3)
    assert f"[init] loaded {n}/{m} tensors from {path}" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "ckpt" / "ball_vitpose_*" / "model.pt"))


def test_init_hf_backbone_tiles_the_first_patch_embedding(tmp_path):
    from upliftingtabletennis_torch.train import run_detection as T

    sd = _hf_b0(seed=1)
    torch.save(sd, tmp_path / "mit_b0.pt")
    model, _ = get_detector("segformerpp_b0", "ball", train=True)
    T.init_hf_backbone(model, str(tmp_path / "mit_b0.pt"), in_frames=3)
    # JAX's merge: the HWIO kernel tiled along its input channels, / 3
    ported = JP.port_hf_segformer_backbone(sd)
    pe0 = ported["patch_embed_0"]["kernel"]
    ported["patch_embed_0"]["kernel"] = np.tile(pe0, (1, 1, 3, 1)) / 3
    want = flax_to_torch({"params": ported})
    _assert_equal_state({k: v.detach() for k, v in model.backbone.state_dict().items()}, want)


def test_cli_hf_backbone_trains_a_step(tiny_tthq, tmp_path, capsys):
    torch.save(_hf_b0(seed=2), tmp_path / "mit_b0.pt")
    _cli(tiny_tthq, tmp_path, "--model", "segformerpp_b0", "--resolution", "96", "64",
         "--hf_backbone", str(tmp_path / "mit_b0.pt"))
    assert "[init] MiT backbone initialized from" in capsys.readouterr().out
