"""The uplifting trainer's path on the card (data/synthetic.py, data/augment.py,
train/uplifting_train.py, data/generate_production.py, train/run_uplifting.py,
eval/run_uplifting_eval.py) against the same code on the CPU.

These tests need a CUDA device and skip without one. They import only torch, so they run
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_uplifting.py

Limits, as chip_smoke.py's uplift_train phase states them: the assembly from the same
draws picks the same camera on all but UPLIFT_PICK_KNIFE_EDGES rows and projects within
1e-2 px where the picks agree; one training step at size small in f32 (no TF32) gives the
CPU's loss within 1e-4 relative and each gradient within 1e-3 of its tensor's max; the
update from the same gradients changes the parameters, EMA and moments within 1e-2 of
each tensor's largest change.
"""
import os

import numpy as np
import pytest
import torch

from uplift_data import analytic_datagen
from upliftingtabletennis_torch.data import augment as A
from upliftingtabletennis_torch.data import synthetic as SYN
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.pipeline.interface import init_weights
from upliftingtabletennis_torch.train import uplifting_train as UT

pytestmark = pytest.mark.cuda
PICK_KNIFE_EDGES, PX_ATOL = 1, 1e-2
LOSS_RTOL, GRAD_REL, UPDATE_REL = 1e-4, 1e-3, 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's entry points run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture(scope="module")
def store():
    return SYN.store_from_datagen(analytic_datagen(48, seed=1))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return (type(tree)(*map(_cpu, tree)) if hasattr(tree, "_fields")
                else tuple(map(_cpu, tree)))
    return tree.cpu() if torch.is_tensor(tree) else tree


def _batches(gen, store, B=32):
    idx = torch.arange(B)
    draws = SYN.draw_batch(B, True, gen, "cuda")
    aug = A.draw_augment(B, SYN.SEQUENCE_LEN, A.AugmentConfig(), gen, "cuda")
    card = SYN.assemble_batch_from_draws(SYN.store_to_device(store, "cuda"), idx.cuda(), draws)
    cpu = SYN.assemble_batch_from_draws(SYN.store_to_device(store, "cpu"), idx, _cpu(draws))
    return card, cpu, A.train_augment(card, draws=aug), A.train_augment(cpu, draws=_cpu(aug))


def test_assembly_on_the_card_matches_the_cpu(gen, store):
    card, cpu, card_aug, cpu_aug = _batches(gen, store)
    same = card["camera_pick"].cpu() == cpu["camera_pick"]
    assert int((~same).sum()) <= PICK_KNIFE_EDGES
    assert float((card["r_img"].cpu() - cpu["r_img"])[same].abs().max()) <= PX_ATOL
    assert torch.equal(card_aug["mask"].cpu()[same], cpu_aug["mask"][same])
    for k in ("times", "r_world"):
        assert torch.equal(card[k].cpu()[same], cpu[k][same]), k


def test_train_step_on_the_card_matches_the_cpu(gen, store):
    _, _, card_aug, _ = _batches(gen, store)
    model = get_uplifting_model("connectstage", "small")
    init_weights(model, 0)
    model_d = get_uplifting_model("connectstage", "small").cuda()
    model_d.load_state_dict(model.state_dict())
    batch_d = UT.batch_from(card_aug)
    loss_d, _ = UT.loss_fn(model_d, batch_d)
    loss_c, _ = UT.loss_fn(model, UT.Batch(*_cpu(tuple(batch_d))))
    g_d = torch.autograd.grad(loss_d, list(model_d.parameters()))
    g_c = torch.autograd.grad(loss_c, list(model.parameters()))
    assert abs(loss_d.item() - loss_c.item()) <= LOSS_RTOL * abs(loss_c.item())
    for a, b in zip(g_d, g_c):
        assert float((a.cpu() - b).abs().max()) <= GRAD_REL * float(b.abs().max())
    # the update from the card's gradients, on both, from an EMA 0.1 away from the weights
    groups = ("params", "ema", "mu", "nu")
    params = [p.detach().clone() for p in model.parameters()]
    start = {"params": params, "ema": [p + 0.1 for p in params],
             "mu": [torch.zeros_like(p) for p in params],
             "nu": [torch.zeros_like(p) for p in params]}

    def changes(device):
        st = UT.TrainState(*[[t.to(device).clone() for t in start[g]] for g in groups], [0])
        UT.apply_update(st, [g.to(device) for g in g_d])
        return {g: [a.cpu() - b for a, b in zip(getattr(st, g), start[g])] for g in groups}

    got, want = changes("cuda"), changes("cpu")
    for g in groups:
        for a, b in zip(got[g], want[g]):
            assert float((a - b).abs().max()) <= UPDATE_REL * float(b.abs().max()), g


def test_generate_production_and_the_cli_on_the_card(gen, tmp_path):
    from upliftingtabletennis_torch.data import generate_production
    from upliftingtabletennis_torch.data.make_synthetic_ttst import write_synthetic_ttst
    from upliftingtabletennis_torch.eval import run_uplifting_eval
    from upliftingtabletennis_torch.train import run_uplifting

    shards = generate_production.main(["--out", str(tmp_path / "data"), "--scale", "0.002",
                                       "--modes", "intermediate,first_long",
                                       "--max_seconds_per_shard", "2"])
    assert len(shards) == 4 and all(e["accepted"] >= 1 for e in shards)
    store = SYN.load_store_npz(str(tmp_path / "data" / "intermediate" / "left_to_right.npz"))
    assert len(store) == shards[0]["accepted"] and np.isfinite(store.blur_positions).all()
    assert write_synthetic_ttst(str(tmp_path), 12) == 12
    common = ["--data_dir", str(tmp_path / "data"), "--model_size", "small", "--batch_size",
              "16", "--save_dir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "runs"),
              "--save_latest_every", "1", "--ttst_dir", str(tmp_path / "ttst")]
    first = run_uplifting.main(common + ["--num_epochs", "1"])
    second = run_uplifting.main(common + ["--num_epochs", "2", "--resume",
                                          os.path.join(first["run_dir"], "latest")])
    assert second["start_epoch"] == 1
    final = run_uplifting.state_dict_of(get_uplifting_model(size="small"), first["state"])
    for k, v in final.items():
        assert torch.equal(v.cpu(), second["resume_state"][k]), k
    out = run_uplifting_eval.main(["--checkpoint",
                                   os.path.join(first["run_dir"], "model_synthetic"),
                                   "--ttst_dir", str(tmp_path / "ttst")])
    assert all(np.isfinite(v) for m in out["ttst"].values() for v in m.values())
