"""The port stands alone and runs on the card unless asked otherwise.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  JAX or the JAX package (checked on the source, by AST).
* Entry points default to CUDA: without a card they raise, and they
  work with ``device="cpu"``.
* ``chip_smoke.py`` exits non-zero and prints no ``ok`` line when there
  is no card, or when it stands in a directory without the port.
"""
import ast
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, device
from repro_torch.models import lm
from repro_torch.serve.engine import Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = configs.get_smoke("qwen3-1.7b")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert device.resolve().type == "cuda"
        return
    from repro_torch.bench import binary as bench_binary, conv as bench_conv
    from repro_torch.kernels import _build, ops

    binary_cfg = dataclasses.replace(CFG, binary_mlp=True)
    for entry in (lambda: lm.init_model(CFG),
                  lambda: lm.init_model(binary_cfg),
                  bench_conv.run, bench_binary.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    # The ops follow their tensors: on CPU tensors the plain versions run
    # and no kernel launches.
    before = dict(_build.LAUNCHES)
    x, w = torch.ones(1, 5, 5, 4), torch.ones(3, 3, 4, 6)
    assert ops.conv2d(x, w).device.type == "cpu"
    assert ops.conv2d_fused(x, w, bias=torch.ones(6)).shape == (1, 3, 3, 6)
    assert ops.int8_conv2d_fused(x.to(torch.int8), w.to(torch.int8), 1.0,
                                 1.0).dtype == torch.float32
    words = torch.zeros(2, 3, dtype=torch.int32)
    assert ops.binary_matmul(words, words.T.contiguous(), 96).shape == (2, 2)
    assert ops.binary_matmul_fused(words, words.T.contiguous(), 96,
                                   binarize=True).dtype == torch.int8
    assert ops.binary_conv2d(torch.zeros(1, 3, 3, 1, dtype=torch.int32),
                             torch.zeros(2, 2, 1, 4, dtype=torch.int32)
                             ).shape == (1, 2, 2, 4)
    assert _build.LAUNCHES == before
    bparams = lm.init_model(binary_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(binary_cfg, bparams, max_len=32)
    params = lm.init_model(CFG, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(CFG, params, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve("cuda")
    eng = Engine(CFG, params, max_len=32, device="cpu")
    assert eng.submit(np.arange(4), 1).result().shape == (1,)


def _run_smoke(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: chip_smoke.py would run")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
