"""The harness driven end to end on the CPU at tiny sizes, in a copy of
the benchmark that adds its cells as new files and entries: the result
line's keys, a piece added without an edit, the import rules, the
planted faults that ``correct`` must catch, and the card-only control."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from portbench import harness
from portbench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(copy, workload, traced):
    run, line = tiny.run_in_copy(copy, workload, seed=2**31 + 5,
                                 seconds=1.5, traced=traced)
    want = list(RESULT_KEYS)
    if traced:
        want.insert(5, "breakdown")
    assert list(line) == want
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    specs = run.cell.per_layer if traced else run.cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in specs}
    if not traced:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_a_piece_added_without_an_edit(copy):
    """A new metric reader and entry, beside the new configurations,
    mixes and cells the copy already added, is read with no edit."""
    (copy / "portbench" / "metrics" / "served_requests.py").write_text(
        textwrap.dedent('''
            def read(run):
                reqs = run.data.get("requests")
                return None if reqs is None else len(reqs)
        '''))
    bench = harness.load_benchmark(copy)
    bench["per_layer"].append({
        "name": "served_requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "client",
        "moves": "serve_tokens_per_s", "workloads": ["serve-tiny-closed"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    run, line = tiny.run_in_copy(copy, "serve-tiny-closed", seconds=1.0,
                                 traced=True)
    assert line["metrics"]["served_requests"]["value"] == run.attempted


def _loaded_tops(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "tnn_tpu"}
TOPS = "import sys, json; print(json.dumps(sorted({m.split('.')[0] " \
       "for m in sys.modules})))"


def test_harness_loads_no_jax(tmp_path):
    code = textwrap.dedent(f'''
        import sys
        from pathlib import Path
        from portbench.tests import tiny
        dest = tiny.make_copy(Path({str(tmp_path)!r}))
        for w in sorted(tiny.CELLS):
            tiny.run_in_copy(dest, w, seconds=0.5, traced=True)
        from portbench import spread, run
        {TOPS}
    ''')
    assert not _loaded_tops(code) & FORBIDDEN


def test_reference_loads_neither_jax_nor_the_program():
    code = "from portbench.reference import gpt2\n" \
           "from portbench import compare, weights, yardstick\n" + TOPS
    assert not _loaded_tops(code) & (FORBIDDEN | {"tnn_tpu_torch"})


# -- planted faults: correct must come out false ------------------------------


def _train_fault(monkeypatch, kind):
    import torch

    from tnn_tpu_torch.train import step as step_mod

    real = step_mod.make_train_step

    def make(model, opt, **kw):
        step = real(model, opt, **kw)

        def faulty(state, data, labels):
            if kind == "half_batch":
                half = data.shape[0] // 2
                return step(state, data[:half], labels[:half])
            keep = {k: v.detach().clone() for k, v in state.params.items()}
            state, m = step(state, data, labels)
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(keep[k])
            return state, m
        return faulty

    monkeypatch.setattr(step_mod, "make_train_step", make)


def _serve_fault(monkeypatch, kind):
    import torch

    from tnn_tpu_torch.ops import paged_attention as pa
    from tnn_tpu_torch.serving.engine import InferenceEngine

    if kind == "state_unchanged":
        monkeypatch.setattr(pa, "scatter_kv_rows",
                            lambda pages, *a, **k: pages)
        return
    real = InferenceEngine._sample

    def altered(self, logits, step):
        out = real(self, logits, step)
        bump = torch.zeros_like(out)
        bump[0, 0] = 1
        return torch.where(bump.bool(), (out + 1) % logits.shape[-1], out)

    monkeypatch.setattr(InferenceEngine, "_sample", altered)


@pytest.mark.parametrize("workload,kind", [
    ("train-tiny", "state_unchanged"), ("train-tiny", "half_batch"),
    ("serve-tiny-closed", "state_unchanged"),
    ("serve-tiny-closed", "token_altered"),
    ("serve-tiny-open", "token_altered")])
def test_planted_fault_is_not_correct(copy, monkeypatch, workload, kind):
    if workload.startswith("train"):
        _train_fault(monkeypatch, kind)
    else:
        _serve_fault(monkeypatch, kind)
    run, line = tiny.run_in_copy(copy, workload, seconds=1.0)
    assert line["correct"] is False, line["checks"]


# -- the lower-precision control, at the cells' own size on the card ----------


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-gpt2s-b32", "serve-gpt2s-sat",
                                      "serve-gpt2s-r80"])
def test_control_is_not_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the program's "
                    "CUDA kernels")
    bench = harness.load_benchmark(tiny.REPO)
    cell = harness.resolve(bench, workload, tiny.REPO)
    control = next(iter(cell.config["control"]))
    for seed in (2**31 + 11, 12, 13):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", workload,
             "--seed", str(seed), "--seconds", "12", "--control", control],
            cwd=tiny.REPO, capture_output=True, text=True, check=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is False, line["checks"]
