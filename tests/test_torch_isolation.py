"""The port stands alone: ``tnn_tpu_torch`` (and ``chip_smoke.py``) import
no ``jax`` and nothing of ``tnn_tpu``, and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tnn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _run(code, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, **kw)


def test_package_imports_with_jax_and_tnn_tpu_unimportable():
    code = """
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import tnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tnn_tpu_torch.__path__,
                                               "tnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tnn_tpu")]
print(len(names), bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 15 and bad.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_tnn_tpu_import_statement(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tnn_tpu"), (path, name)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from tnn_tpu_torch.models.gpt2 import GPT2
    from tnn_tpu_torch.serving.engine import InferenceEngine

    with pytest.raises(RuntimeError, match="is_available"):
        GPT2(vocab_size=64, max_len=16, num_layers=1, d_model=16,
             num_heads=2)
    model = GPT2(vocab_size=64, max_len=16, num_layers=1, d_model=16,
                 num_heads=2, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        InferenceEngine(model, num_blocks=8, block_size=4)
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.serve", "--model",
         "gpt2_tiny"], input=json.dumps({"tokens": [1]}) + "\n", cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "is_available() is False" in proc.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
