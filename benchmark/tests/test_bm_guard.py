"""The import guard (top-level names compared whole) and the refusal to
run without the cards a cell asks for."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import guard

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    loaded = ["ddsp_tpu_torch", "ddsp_tpu_torch.models", "jaxtyping", "flaxen", "torch"]
    assert guard.forbidden_modules(loaded) == []
    bad = ["ddsp_tpu", "ddsp_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert guard.forbidden_modules(loaded + bad) == sorted(bad)
    with pytest.raises(SystemExit, match="ddsp_tpu.ops"):
        guard.check_imports(loaded + ["ddsp_tpu.ops"])
    guard.check_imports(loaded)


def test_a_cell_run_loads_no_jax():
    """A whole cell run on the CPU, in a process of its own, ends with
    neither JAX nor the JAX package in ``sys.modules``."""
    code = ("import torch; torch.set_num_threads(1)\n"
            "from benchmark import guard\n"
            "from benchmark.tests import tiny\n"
            "for mix in (tiny.SERVE_MIX, tiny.TRAIN_MIX):\n"
            "    tiny.drive(tiny.cpu_context(mix, seconds=0.05))\n"
            "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_is_a_failure_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train_tiny_b384",
                          "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_too_few_cards_is_a_failure():
    one = SimpleNamespace(is_available=lambda: True, device_count=lambda: 1)
    guard.check_cards(1, cuda=one)
    with pytest.raises(SystemExit, match="needs 4"):
        guard.check_cards(4, cuda=one)
    with pytest.raises(SystemExit, match="no CUDA"):
        guard.check_cards(1, cuda=SimpleNamespace(is_available=lambda: False))


def test_the_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for path in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve_full_n128",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _emit_in_a_process(tmp_path: Path, reader: str) -> subprocess.CompletedProcess:
    """The end of a traced run (its result line built, the cell's per-layer
    readers loaded, the result emitted) in a process of its own, over a
    copy of the registry whose one per-layer metric has ``reader`` as its
    source; a stub package named ``jax`` lies on the path."""
    bench = tmp_path / "benchmark"
    (bench / "metrics").mkdir(parents=True)
    (bench / "metrics" / "probe_ms.serve.py").write_text(reader)
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec["workloads"][0]
    spec["per_layer"] = [{"name": "probe_ms.serve", "unit": "ms", "better": "lower",
                          "source": "device_trace", "layer": "probe",
                          "moves": spec["end_to_end"][0]["name"],
                          "workloads": [cell["name"]]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (f"import sys; sys.path.insert(0, {str(tmp_path / 'stub')!r})\n"
            "from pathlib import Path\n"
            "from types import SimpleNamespace\n"
            "from benchmark import run\n"
            "from benchmark.registry import Registry\n"
            f"reg = Registry(Path({str(tmp_path)!r}), Path({str(bench)!r}))\n"
            "window = SimpleNamespace(busy_s=0.5, window_s=1.0, top_ops=[], idle_by_range=[])\n"
            "res = {'numbers': {'n': 0.0}, 'attempted': 3, 'failed': 0, 'window': window}\n"
            f"line = run.result_line(res, reg, {cell['name']!r}, {{'n': 1.0}}, True,\n"
            "                       {'platform': 'gpu', 'count': 1})\n"
            "run.emit(line, [])\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """The last import check comes after the per-layer readers are loaded:
    a reader that imports ``jax`` leaves no result and a non-zero exit."""
    out = _emit_in_a_process(tmp_path, "import jax\n\n\ndef read(w):\n    return 1.0\n")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: jax" in out.stderr


def test_a_clean_reader_gives_the_result(tmp_path):
    out = _emit_in_a_process(tmp_path, "def read(w):\n    return 1.0\n")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {"probe_ms.serve": {"value": 1.0, "unit": "ms"}}
    assert line["correct"] is True
