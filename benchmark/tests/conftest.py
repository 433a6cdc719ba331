"""Shared pieces of the benchmark's CPU tests: the cells at a tiny size (small frames,
small detector inputs, short rallies), with the port's detector resolutions set to match."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_FRAME = (128, 72)
TINY_INPUT = (64, 32)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


def tiny(cell):
    """The cell at a size the CPU runs in seconds: every width as published, the frames,
    the detector inputs, the pool and the rallies small."""
    cell = copy.deepcopy(cell)
    cfg, traffic = cell.config, cell.traffic
    cfg["frame_wh"] = list(TINY_FRAME)
    for det in cfg["detectors"].values():
        det["input_wh"] = list(TINY_INPUT)
    traffic.update(rally_groups=[[9, 14], [12, 11]], pool_frames=20, warmup_frames=10,
                   trace_seconds=0.5)
    traffic["frames"].update(speed_px=[1.0, 3.0], ball_sigma_px=2.0)
    cell.check["sample_frames"] = 6
    return cell


def tiny_train(cell):
    """A training cell at a size the CPU runs in seconds: every width as published, the
    frames, the model input and the evaluation grid small."""
    cell = copy.deepcopy(cell)
    cell.config["frame_wh"] = list(TINY_FRAME)
    cell.config["model"]["input_wh"] = list(TINY_INPUT)
    cell.config["eval_wh"] = [96, 54]
    cell.traffic["pool_frames"] = 16
    cell.traffic["frames"].update(speed_px=[1.0, 3.0], ball_sigma_px=2.0)
    return cell


@pytest.fixture
def tiny_port(monkeypatch):
    """The port's detectors built at TINY_INPUT."""
    from upliftingtabletennis_torch.models import factory

    for name in factory.DETECTOR_RESOLUTIONS:
        monkeypatch.setitem(factory.DETECTOR_RESOLUTIONS, name, TINY_INPUT)
    return TINY_INPUT


@pytest.fixture
def tiny_cell(tiny_port):
    from benchmark import harness

    def make(name):
        cell = harness.load_cell(name)
        return tiny_train(cell) if cell.workload["entry"] == "train" else tiny(cell)
    return make
