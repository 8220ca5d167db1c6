"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card or raise — they never fall back to the
CPU unless the caller asks for it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.api\n"
        "import repro_torch.kernels.ops, repro_torch.weights\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_training_path_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.training.trainer\n"
        "import repro_torch.training.checkpoint, repro_torch.training.data\n"
        "import repro_torch.kernels.flash_attention\n"
        "from repro_torch.launch.train import run_training\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ModelExecutor
    from repro_torch.serving.serve_step import build_serve_fns
    cfg = smoke_config("qwen3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve_fns(cfg, batch=2, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelExecutor(cfg, EngineConfig(max_slots=2, max_len=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--smoke"])


def test_chip_smoke_refuses_to_run_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
