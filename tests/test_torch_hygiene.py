"""The port imports torch, numpy and the standard library only: never JAX, flax,
orbax, safetensors or the JAX package, and builds no kernel at import."""
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "upliftingtabletennis_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "safetensors", "upliftingtabletennis_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_modules()) + ["chip_smoke"]
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + [f"bad = [m for m in {BANNED!r} if m in sys.modules]",
           "assert not bad, bad",
           "import upliftingtabletennis_torch.ops._build as b",
           "assert not b._loaded, 'a kernel was built or loaded at import'",
           "print(len(sys.modules))"])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(BANNED) + r")\b", re.M)


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_source_has_no_banned_import(path):
    assert not _IMPORT.findall((REPO / path).read_text()), path


def test_kernel_sources_build_without_pytorch_headers():
    """One plain-C-interface library per CUDA source: no torch/extension.h (minutes of nvcc)."""
    from upliftingtabletennis_torch.ops import _build

    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        assert "torch/extension.h" not in text and "extern \"C\"" in text
        assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
