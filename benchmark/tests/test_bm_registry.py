"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries, in a copy of the benchmark, and the harness finds
them without an edit to any existing file."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark import tracing
from benchmark.registry import Registry

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())

    bench = tmp_path / "benchmark"
    (bench / "configs" / "ddsp16k_solo.json").write_text(json.dumps(
        dict(json.loads((bench / "configs" / "ddsp44k_tiny.json").read_text()),
             sample_rate=16000, n_harmonics=60, n_noise_filters=65)))
    (bench / "workloads" / "serve_n8.json").write_text(json.dumps(
        dict(json.loads((bench / "workloads" / "serve_n128.json").read_text()), slots=8)))
    (bench / "metrics" / "copies_ms.serve.py").write_text(
        "def read(w):\n    return w.per_unit_ms('copies') if 'copies' in w.device_s else None\n")
    spec["configs"].append({"name": "ddsp16k_solo", "source": "https://example.org/solo",
                            "file": "benchmark/configs/ddsp16k_solo.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "serve_solo_n8", "config": "ddsp16k_solo",
                              "traffic": "serve_n8", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("serve_solo_n8")
    spec["per_layer"].append({"name": "copies_ms.serve", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "serving wrapper",
                              "moves": "serve_streams_rt"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(tmp_path, bench)
    listing = reg.listing()
    assert "ddsp16k_solo" in listing["configs"]
    assert "serve_n8" in listing["workloads"]
    assert "copies_ms.serve" in listing["metrics"]
    cell = reg.cell("serve_solo_n8")
    assert reg.config(cell["config"])["n_harmonics"] == 60
    assert reg.traffic(cell["traffic"])["slots"] == 8
    assert "serve_hop_ms_p95" in reg.end_to_end("serve_solo_n8")
    # a metric without a list of cells is read in every cell reporting its
    # end-to-end metric, and only there
    assert "copies_ms.serve" in [m["name"] for m in reg.per_layer("serve_solo_n8")]
    assert "copies_ms.serve" not in [m["name"] for m in reg.per_layer("train_tiny_b384")]
    window = tracing.Window(window_s=1.0, busy_s=0.5, units=10, n_ops=100,
                            device_s={"copies": 0.02})
    assert reg.reader("copies_ms.serve")(window) == 2.0
    assert reg.reader("copies_ms.serve")(tracing.Window(1.0, 0.5, 10, 100)) is None

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_finds_its_parts():
    reg = Registry(ROOT)
    listing = reg.listing()
    for cell in reg.spec["workloads"]:
        assert reg.config(cell["config"])
        assert cell["traffic"] in listing["workloads"]
        assert reg.limits(cell["name"]), cell["name"]
        for m in reg.per_layer(cell["name"]):
            assert m["name"] in listing["metrics"]
            assert reg.unit(m["name"]) == m["unit"]
