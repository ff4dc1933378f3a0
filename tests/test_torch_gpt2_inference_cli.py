"""The port's ``cli.gpt2_inference`` (``tnn_tpu.cli.gpt2_inference``) on the
CPU: ``--fused`` generates through ``fused_generate`` (K8's plain version
here), ``--int8`` through ``generate`` on the int8 copy; both print the
JAX CLI's lines. ``gpt2_tiny`` (2L/128d/2h) quantizes all four matmuls of
every block (both dims >= 128, multiples of 128: no padding), so the
fused path runs it; a model that quantizes nothing is refused by
``stack_decode_weights`` (``tests/test_torch_fused_decode.py``)."""
import ast

import numpy as np
import pytest
import torch

from tnn_tpu_torch.cli import gpt2_inference
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.models.fused_decode import fused_generate
from tnn_tpu_torch.models.gpt2 import generate
from tnn_tpu_torch.nn.quant import quantize_for_decode

PROMPT = "The meaning of life is"


def _run(capsys, *flags):
    assert gpt2_inference.main(["--model", "gpt2_tiny", "--device", "cpu",
                                "-n", "3", *flags]) == 0
    return capsys.readouterr().out.splitlines()


def _ids(lines):
    line = [ln for ln in lines if ln.startswith("generated ids:")][0]
    return ast.literal_eval(line.split(":", 1)[1].rsplit("...", 1)[0])


@pytest.fixture(scope="module")
def tiny_int8():
    return quantize_for_decode(zoo.create("gpt2_tiny", device="cpu", seed=0))


def _prompt(model):
    return torch.from_numpy(np.frombuffer(PROMPT.encode(), np.uint8)
                            .astype(np.int64))[None] % model.vocab_size


def test_fused_cli_runs_fused_generate(capsys, tiny_int8):
    lines = _run(capsys, "--fused")
    assert lines[0].startswith("no --model-file: random-weight gpt2_tiny")
    assert lines[1].startswith("int8 weights: ")   # --fused implies --int8
    assert lines[2] == "no --vocab: using byte-level prompt ids"
    assert lines[-1].startswith("3 tokens in ")
    want = fused_generate(tiny_int8, _prompt(tiny_int8), 3)
    assert _ids(lines) == want[0].tolist()


def test_int8_cli_runs_generate_on_the_int8_copy(capsys, tiny_int8):
    lines = _run(capsys, "--int8")
    assert lines[1].startswith("int8 weights: ")
    want = generate(tiny_int8, _prompt(tiny_int8), 3)
    assert _ids(lines) == want[0].tolist()
    lines = _run(capsys, "--top-k", "5")
    assert lines[0] == ("--top-k/--top-p need sampling: defaulting "
                        "--temperature 1.0")
    assert not any(ln.startswith("int8 weights") for ln in lines)


@pytest.mark.parametrize("flag", ["--vocab", "--model-file"])
def test_unported_inputs_raise(flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        gpt2_inference.main(["--model", "gpt2_tiny", "--device", "cpu",
                             flag, "x"])


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        gpt2_inference.main(["--model", "gpt2_tiny", "-n", "1"])
