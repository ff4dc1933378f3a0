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
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))


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
import tools.torch_hbm_fit, tools.torch_trace_step
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tnn_tpu")]
print(len(names), bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 15 and bad.strip() == "[]"


def test_serving_exports_every_reference_name_without_jax():
    """``tnn_tpu_torch.serving`` exports every name of the JAX package's
    ``tnn_tpu.serving.__all__`` (read from its source, not imported), with
    jax and tnn_tpu unimportable."""
    tree = ast.parse((ROOT / "tnn_tpu" / "serving" / "__init__.py")
                     .read_text())
    want = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "__all__")
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
import tnn_tpu_torch.serving as s
want = {want!r}
missing = [n for n in want if not hasattr(s, n)]
print(sorted(set(want) - set(s.__all__)), missing)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


TRAINING_MODULES = ["utils.env", "utils.logging", "utils.hardware",
                    "utils.config", "nn.optimizers", "nn.schedulers",
                    "nn.losses", "nn.metrics", "nn.lm_loss", "models.gpt2",
                    "models.llama", "models.sampling", "train.step",
                    "train.loop", "data.loader", "data.token_stream",
                    "checkpoint", "cli.train_gpt2"]


def test_training_slice_imports_torch_and_no_jax():
    """The LM-training slice's modules import with jax and tnn_tpu
    unimportable, and bring torch in; ``train_model`` and ``Checkpoint``
    are reachable from the package."""
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
for name in {TRAINING_MODULES!r}:
    importlib.import_module("tnn_tpu_torch." + name)
from tnn_tpu_torch.train import train_model, make_predict
from tnn_tpu_torch.checkpoint import Checkpoint
print("torch" in sys.modules,
      [m for m in sys.modules if m.split(".")[0] in ("jax", "tnn_tpu")])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True []"


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


@pytest.mark.parametrize(
    "path", sorted((ROOT / "tnn_tpu_torch" / "ops").glob("*.py")),
    ids=lambda p: p.name)
def test_ops_import_no_layer_above_them(path):
    """The kernel wrappers and the matmul dispatch sit below the layers and
    models that call them: no import, at any depth of the file, reaches
    up."""
    above = ("nn", "models", "serving", "train", "data", "cli")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level >= 2:
            assert (node.module or "").split(".")[0] not in above, (
                path, node.module)
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            parts = (node.module or "").split(".")
            assert parts[0] != "tnn_tpu_torch" or parts[1:2] == ["ops"] \
                or parts[1:2] == ["core"], (path, node.module)


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
    # the trainer refuses before it reads the corpus (prepare_corpus
    # computes nothing on a device: test_torch_train_cli runs it here)
    proc = subprocess.run(
        [sys.executable, "-m", "tnn_tpu_torch.cli.train_gpt2", "--tokens",
         "no-such-dir"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "is_available() is False" in proc.stderr
    with pytest.raises(RuntimeError, match="is_available"):
        from tnn_tpu_torch.cli import train_gpt2
        train_gpt2.main(["--tokens", "no-such-dir"])


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_kernel_sources_plain_c_and_int8_paths_run_without_nvcc():
    """Every CUDA source has a plain C entry and no PyTorch header, and the
    int8 modules compute their plain versions on CPU tensors without
    building anything: a host without nvcc (this one) runs them."""
    sources = sorted((ROOT / "tnn_tpu_torch" / "csrc").glob("*.cu"))
    assert {p.name for p in sources} >= {"paged_attention.cu",
                                         "quant_matmul.cu",
                                         "decode_stack.cu"}
    for path in sources:
        text = path.read_text()
        assert 'extern "C"' in text and "torch/" not in text, path
    assert 'tnn_paged_attention_int8' in (
        ROOT / "tnn_tpu_torch" / "csrc" / "paged_attention.cu").read_text()
    assert 'tnn_fused_decode_stack' in (
        ROOT / "tnn_tpu_torch" / "csrc" / "decode_stack.cu").read_text()
    code = """
import os, torch
from tnn_tpu_torch.ops import paged_attention as pa, quant_matmul as qm
from tnn_tpu_torch.ops import runtime
from tnn_tpu_torch.nn import quant
from tnn_tpu_torch.models.gpt2 import GPT2
iw = qm.quantize_int8(torch.randn(256, 128))
assert qm.qmatmul(torch.randn(300, 256), iw).shape == (300, 128)
rows = torch.randn(2, 3, 4, 64)
pages = pa.QuantPages(torch.zeros(1, 4, 4, 4, 64, dtype=torch.int8),
                      torch.zeros(1, 4, 4, 4, 1))
tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
starts = torch.zeros(2, dtype=torch.int32)
q_lens = torch.tensor([3, 2], dtype=torch.int32)
pa.scatter_kv_chunk(pages, tables, starts, rows, q_lens, layer=0)
out = pa.paged_attention(torch.randn(2, 3, 8, 64), pages, pages, tables,
                         q_lens, q_lens=q_lens)
assert out.shape == (2, 3, 8, 64) and torch.isfinite(out).all()
m = quant.quantize_for_decode(GPT2(vocab_size=256, max_len=16, num_layers=1,
                                   d_model=128, num_heads=2, device="cpu"))
assert m(torch.arange(8)[None]).shape == (1, 8, 256)
assert runtime._loaded == {} and pa.paged_attention.int8_launches == 0
assert qm.int8_matmul.launches == 0
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_fused_decode_path_runs_without_nvcc():
    """The fused decode slice (``ops.decode_stack``, ``models.fused_decode``,
    the engine's "fused" and "standard" paths, ``cli.gpt2_inference``)
    computes its plain versions on CPU tensors without building anything,
    and its modules import nothing of JAX (the tests above scan them)."""
    code = """
import torch
from tnn_tpu_torch.ops import decode_stack as ds, runtime
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.models.fused_decode import fused_generate
from tnn_tpu_torch.nn.quant import quantize_for_decode
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.cli import gpt2_inference
m = GPT2(vocab_size=256, max_len=32, num_layers=1, d_model=128,
         num_heads=2, device="cpu")
q = quantize_for_decode(m)
assert fused_generate(q, torch.arange(4)[None], 3).shape == (1, 3)
for path in ("fused", "standard"):
    eng = InferenceEngine(m, num_blocks=8, block_size=4, max_batch_size=2,
                          quant_weights=True, decode_path=path, device="cpu")
    for _ in range(2):
        eng.submit([1, 2, 3], 3)
    out = eng.run_until_complete()
    assert eng.stats()["decode_path"] == path and len(out) == 2
assert runtime._loaded == {} and ds.fused_decode_stack.launches == 0
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_text_and_model_file_modules_run_with_jax_unimportable(tmp_path):
    """The tokenizer, the ``.tnn`` reader and writer and the config
    registry run with jax and tnn_tpu blocked: a vocab is trained, saved,
    loaded and used; a model is saved, loaded back bit for bit and served
    whole-prompt on the CPU."""
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
import torch
from tnn_tpu_torch import checkpoint
from tnn_tpu_torch.core.module import module_from_config
from tnn_tpu_torch.data.tokenizer import Tokenizer, train_bpe
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving.engine import InferenceEngine
train_bpe(["one two three two one"] * 3, 270).save({str(tmp_path)!r} + "/v.bin")
tok = Tokenizer().load({str(tmp_path)!r} + "/v.bin")
assert tok.decode(tok.encode("two one")) == "two one"
m = GPT2(vocab_size=tok.vocab_size, max_len=32, num_layers=1, d_model=16,
         num_heads=2, device="cpu")
checkpoint.save_model({str(tmp_path)!r} + "/m.tnn", m)
m2 = checkpoint.load_model({str(tmp_path)!r} + "/m.tnn", device="cpu")
assert all(torch.equal(a, b) for (_, a), (_, b) in
           zip(m.jax_param_paths(), m2.jax_param_paths()))
assert module_from_config(m.get_config(), device="cpu").get_config() == \
    m.get_config()
eng = InferenceEngine(m2, num_blocks=8, block_size=4, device="cpu",
                      chunked_prefill=False)
rid = eng.submit(tok.encode("one two"), 3)
assert len(eng.run_until_complete()[rid]) == 3
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "tnn_tpu")]
print("ok", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok []", \
        proc.stderr


def test_chip_smoke_defines_each_top_level_name_once():
    """A later phase's helper must not shadow an earlier phase's: the
    script is one module, and a second ``def`` of a name silently replaces
    the first for every phase."""
    names = [n.name if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             else t.id
             for n in ast.parse((ROOT / "chip_smoke.py").read_text()).body
             for t in ([n] if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                       else getattr(n, "targets", []))
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             or isinstance(t, ast.Name)]
    assert sorted({n for n in names if names.count(n) > 1}) == []


CONTROL_AND_HOST_MODULES = ["distributed", "distributed.protocol",
                            "distributed.transport",
                            "distributed.coordinator", "distributed.worker",
                            "native", "native.lib", "native.api",
                            "cli.dist_coordinator", "cli.dist_worker",
                            "utils.affinity"]


def test_control_plane_and_native_runtime_import_with_jax_unimportable():
    """The control plane, the native runtime, the two distributed CLIs and
    the affinity helpers import with jax and tnn_tpu blocked; a coordinator
    and a worker of the port exchange a config and shut down."""
    code = f"""
import importlib, importlib.abc, sys, threading
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
for name in {CONTROL_AND_HOST_MODULES!r}:
    importlib.import_module("tnn_tpu_torch." + name)
from tnn_tpu_torch.distributed import Coordinator, Worker
coord = Coordinator(1)
out = {{}}
t = threading.Thread(target=lambda: out.setdefault(
    "w", Worker("127.0.0.1", coord.port()).start()))
t.start()
coord.wait_for_workers(timeout=60)
t.join(timeout=60)
coord.deploy_config({{"model_name": "mnist_cnn"}}, timeout=60)
assert out["w"].config == {{"model_name": "mnist_cnn"}}
coord.shutdown()
out["w"].join(timeout=30)
print([m for m in sys.modules if m.split(".")[0] in ("jax", "tnn_tpu")])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# names of a JAX ``__all__`` that have no port counterpart by design: the
# Pallas subpackage (its modules are the port's ``ops``)
JAX_ONLY_NAMES = {"tnn_tpu.ops": {"pallas"}}
# where a JAX package's names live in the port, where the path differs
PORT_HOME = {"tnn_tpu.ops.pallas": "tnn_tpu_torch.ops"}


def test_every_jax_package_export_has_a_port_counterpart():
    """Each name of each ``tnn_tpu`` package's ``__all__`` (read from its
    source, not imported) is an attribute of the port's package at the
    same path, with jax and tnn_tpu unimportable; ``JAX_ONLY_NAMES`` lists
    the names left out by design."""
    wants = {}
    for init in sorted((ROOT / "tnn_tpu").rglob("__init__.py")):
        tree = ast.parse(init.read_text())
        names = next((ast.literal_eval(n.value) for n in tree.body
                      if isinstance(n, ast.Assign)
                      and getattr(n.targets[0], "id", "") == "__all__"),
                     None)
        if names is None:
            continue
        pkg = ".".join(init.parent.relative_to(ROOT).parts)
        port = PORT_HOME.get(pkg, pkg.replace("tnn_tpu", "tnn_tpu_torch",
                                              1))
        wants[port] = sorted(set(names) - JAX_ONLY_NAMES.get(pkg, set()))
    assert len(wants) >= 13 and "tnn_tpu_torch.native" in wants
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tnn_tpu"):
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
missing = {{}}
for pkg, names in {wants!r}.items():
    mod = importlib.import_module(pkg)
    gone = [n for n in names if not hasattr(mod, n)]
    exported = set(getattr(mod, "__all__", ()))
    unlisted = [n for n in names if n not in exported]
    if gone or unlisted:
        missing[pkg] = (gone, unlisted)
print(missing)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "{}"


def test_param_census_and_console_entries():
    """``param_count`` / ``param_bytes`` count a module's parameters and a
    tree's leaves; every CLI module has ``cli = console_entry(main)``,
    which passes an int exit code on and drops any other return value."""
    import numpy as np

    import tnn_tpu_torch
    from tnn_tpu_torch.cli import console_entry

    lin = torch.nn.Linear(3, 4)
    assert tnn_tpu_torch.param_count(lin) == 16
    assert tnn_tpu_torch.param_bytes(lin) == 64
    tree = {"a": np.zeros((2, 3), np.float16),
            "b": [torch.zeros(5, dtype=torch.bfloat16), None]}
    assert tnn_tpu_torch.param_count(tree) == 11
    assert tnn_tpu_torch.param_bytes(tree) == 22
    assert console_entry(lambda: 3)() == 3
    assert console_entry(lambda: {"x": 1})() is None
    assert console_entry(lambda: True)() is None
    for path in sorted((ROOT / "tnn_tpu_torch" / "cli").glob("*.py")):
        if path.name != "__init__.py":
            assert "\ncli = console_entry(main)\n" in path.read_text(), path
