"""The port stands alone: no JAX, nothing of the JAX package.

``repro_torch``, ``chip_smoke.py`` and the port's examples
(``examples/torch_*.py``) must import neither ``jax`` nor anything under
``repro`` — the port keeps its own copies of the numpy
modules it needs — and the engine's default device is the card, so on a
machine without one it raises instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in sys.modules if m.startswith('repro_torch'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    modules = out.stdout.split()
    assert len(modules) >= 25
    for name in ("knn", "pairwise", "flash_attention"):
        assert f"repro_torch.kernels.{name}" in modules
    for name in ("models.transformer", "models.model", "models.moe", "models.rwkv", "models.ssm", "models.whisper",
                 "configs.qwen2_1_5b", "configs.whisper_tiny",
                 "serving.engine", "launch.serve", "launch.train", "train", "train.optim", "data.pipeline",
                 "tree"):
        assert f"repro_torch.{name}" in modules


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro"} & set(roots), f"{path}:{node.lineno}"


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    from repro_torch import StreamingClusterEngine, get_backend

    with pytest.raises(RuntimeError, match="GPU"):
        StreamingClusterEngine(dim=4)
    with pytest.raises(RuntimeError, match="GPU"):
        get_backend()


def test_variant_modules_are_covered():
    """The card-only timing modules (``python -m repro_torch.kernels.<name>``)
    are held to the same no-JAX rule and import on a machine without a card."""
    files = _port_files()
    names = ("flash_variants", "flash_fwd_variants", "flash_bwd_variants", "hierarchy_variants", "strip_variants",
             "grid_variants")
    for name in names:
        assert PORT / "kernels" / f"{name}.py" in files, name
    code = "import importlib\n" + "".join(f"importlib.import_module('repro_torch.kernels.{n}')\n" for n in names)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_csrc_sources_include_only_the_port():
    """Every kernel source and header on disk (``kernels/csrc``; that the
    build lists them all is ``test_torch_routes.py``'s) includes nothing but
    the port's own headers and the toolkit's: no source of the JAX package,
    no package of finished kernels."""
    from repro_torch.kernels import _build

    csrc = PORT / "kernels" / "csrc"
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                inc = line.split()[1]
                if inc.startswith('"'):
                    assert inc.strip('"') in _build._HEADERS, f"{path.name}: {line}"
                else:
                    assert not any(k in inc for k in ("cutlass", "cute", "cub/", "thrust", "torch")), f"{path.name}: {line}"


def test_training_modules_are_covered():
    files = _port_files()
    for rel in ("src/repro_torch/train/optim.py", "src/repro_torch/launch/train.py", "src/repro_torch/data/pipeline.py",
                "src/repro_torch/tree.py", "examples/torch_train_lm_with_curation.py"):
        assert ROOT / rel in files, rel
