"""The port's `eval/run_detection_eval.py` against the JAX package's.

`evaluate_checkpoint` of each package on the same tiny TTHQ layout (chip_smoke.py's
`tiny_tthq`: two videos of 320x180 synthetic frames with ball and table labels, video 1
the test split), with the committed closed-loop detectors (WASB for the ball, with and
without the flip test; segformerpp_b0 for the table): JAX's from its Orbax checkpoints
under artifacts/closed_loop/, the port's from their conversions under
upliftingtabletennis_torch/weights/closed_loop/, both at a 320x192 input. The JAX
function jits its evaluation transform; in evaluation mode that is a pure resize (the
red/blue swap of the jitted augmentation is in the training-mode colour jitter), so it
is compared jitted. Tolerance: the PCK values exactly, avg_dist within 1e-3 px at
1920x1080 (the detectors' heatmaps agree within 2e-4 of their max,
tests/test_torch_closed_loop.py; the peaks within 1e-2 px).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from upliftingtabletennis_tpu.eval import run_detection_eval as JE
from upliftingtabletennis_torch.eval import run_detection_eval as E

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVG_DIST_PX = 1e-3
RES = (320, 192)


@pytest.fixture(scope="module")
def tthq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tthq"))
    chip_smoke.tiny_tthq(root)
    return root


def _ckpts(task):
    return (os.path.join(REPO, "artifacts", "closed_loop", f"{task}_detector"),
            os.path.join(REPO, "upliftingtabletennis_torch", "weights", "closed_loop",
                         f"{task}_detector"))


@pytest.mark.parametrize("task,flip", [("ball", False), ("ball", True), ("table", False)],
                         ids=["ball", "ball_flip", "table"])
def test_evaluate_checkpoint_matches_jax(tthq, task, flip):
    jax_ckpt, ckpt = _ckpts(task)
    want = JE.evaluate_checkpoint(task, jax_ckpt, tthq, batch_size=2, resolution=RES,
                                  flip_test=flip)
    got = E.evaluate_checkpoint(task, ckpt, tthq, batch_size=2, resolution=RES, flip_test=flip,
                                device="cpu")
    assert sorted(got) == sorted(want) == ["avg_dist", "pck10", "pck2", "pck20", "pck5"]
    for k in ("pck2", "pck5", "pck10", "pck20"):
        assert got[k] == pytest.approx(want[k], abs=1e-7), k
    assert abs(got["avg_dist"] - want["avg_dist"]) <= AVG_DIST_PX
    if task == "ball":  # the trained WASB finds the blobs
        assert got["pck5"] == 1.0


def test_cli_on_the_cpu(tthq, capsys):
    """The committed checkpoints run at the resolution they were trained at
    (`render_res`, 960x544), as the evaluation with that resolution given."""
    _, ckpt = _ckpts("ball")
    out = E.main(["--task", "ball", "--checkpoints", ckpt, "--data_root", tthq,
                  "--batch_size", "2", "--device", "cpu"])
    assert list(out) == [ckpt] and np.isfinite(list(out[ckpt].values())).all()
    assert "pck2=" in capsys.readouterr().out
    assert out[ckpt] == E.evaluate_checkpoint("ball", ckpt, tthq, 2, resolution=(960, 544),
                                              device="cpu")


def test_default_device_is_the_card(tthq):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        E.evaluate_checkpoint("ball", _ckpts("ball")[1], tthq, batch_size=2, resolution=RES)


def test_peak_rule_charges_only_the_kernels_own_misses():
    """chip_smoke.py's rule for the card's detections against the CPU's: a detection seen
    by one side only is charged; a peak the kernel path misses by more than CL_PEAK_PX is
    charged unless the bf16 plain path misses it too."""
    f32 = torch.tensor([[0.0, 0.0], [10.0, 10.0], [20.0, 20.0], [30.0, 30.0]])
    card = f32 + torch.tensor([[0.5, 0.0], [5.0, 0.0], [5.0, 0.0], [0.0, 0.0]])
    bf16 = f32 + torch.tensor([[0.0, 0.0], [0.0, 0.0], [4.0, 0.0], [0.0, 0.0]])
    seen = torch.tensor([True, True, True, True])
    assert chip_smoke.peak_rule(card, bf16, f32, seen, seen) == (4, 1)
    seen_card = torch.tensor([True, True, True, False])
    assert chip_smoke.peak_rule(card, bf16, f32, seen_card, seen) == (4, 2)
