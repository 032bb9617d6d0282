"""The port stands alone: it imports with ``jax`` blocked, names nothing of
the JAX package, and never falls back to the CPU when CUDA is asked for."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "codenerf_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "trunk_ablation.py",
                                         REPO / "quality_probe.py"]


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import codenerf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'codenerf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = {'codenerf_tpu_torch.pose_opt', 'codenerf_tpu_torch.core.poses',"
        " 'codenerf_tpu_torch.optimization.pose_opt',"
        " 'codenerf_tpu_torch.ops.composite',"
        " 'codenerf_tpu_torch.quality_report',"
        " 'codenerf_tpu_torch.data.synthetic',"
        " 'codenerf_tpu_torch.data.native',"
        " 'codenerf_tpu_torch.parallel.mesh'}\n"
        "assert new <= set(names), new - set(names)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'codenerf_tpu' "
        "or m.startswith(('codenerf_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "codenerf_tpu", "optax",
                                "orbax"), f"{path}: imports {name}"


def test_cuda_request_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal is moot")
    from codenerf_tpu_torch import resolve_device
    from codenerf_tpu_torch.config import NetConfig
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.optimization.codes_opt import CodeOptimizer
    from codenerf_tpu_torch.optimize import main

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    cfg = NetConfig(W=256, latent_dim=8)
    with pytest.raises(RuntimeError, match="cuda"):
        CodeOptimizer(CodeNeRF(cfg), None, torch.zeros(8), torch.zeros(8))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--jsonfile", "srncar_fused.json", "--exps_root",
              str(tmp_path)])


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and '"ok"' not in out.stdout
